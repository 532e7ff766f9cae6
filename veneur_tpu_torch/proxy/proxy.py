"""veneur-proxy: consistent-hash gRPC router in front of the global tier
(a copy of veneur_tpu/proxy/proxy.py; it imports no torch).

Parity with reference proxy/proxy.go:33-120 and
proxy/handlers/handlers.go:40-164: a gRPC server accepting
Forward.SendMetrics (unary MetricList) and SendMetricsV2 (metric stream);
each metric is keyed by name + type + tags (minus configured ignored
tags), mapped through the consistent-hash ring to a destination, and
enqueued on that destination's buffered sender. A discovery loop
refreshes the destination pool every `discovery_interval`; the
healthcheck fails while the ring is empty (handlers.go:30-38).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from concurrent import futures
from typing import Dict, List, Optional

import grpc

from veneur_tpu_torch import native
from veneur_tpu_torch.core.latency import LatencyObservatory
from veneur_tpu_torch.core.ledger import FlowLedger, LedgerImbalance
from veneur_tpu_torch.core.telemetry import Telemetry
from veneur_tpu_torch.forward.protos import forward_pb2, metric_pb2
from veneur_tpu_torch.forward.wire import (TokenDeduper, encode_flow_counts,
                                           extract_interval, extract_trace,
                                           metadata_value)
from veneur_tpu_torch.ops import hll_ref
from veneur_tpu_torch.proxy.destinations import Destinations
from veneur_tpu_torch.proxy.discovery import Discoverer, StaticDiscoverer
from veneur_tpu_torch.proxy.health import RingHealth
from veneur_tpu_torch.proxy.ring import EmptyRingError
from veneur_tpu_torch.trace.store import EXEMPLAR_KEY, SelfTracePlane
from veneur_tpu_torch.util.grpcstats import RpcStats
from veneur_tpu_torch.util.grpctls import GrpcTLS
from veneur_tpu_torch.util.matcher import TagMatcher

logger = logging.getLogger("veneur_tpu_torch.proxy")


class ProxyServer:
    def __init__(self, discoverer: Discoverer,
                 forward_service: str = "veneur-global",
                 listen_address: str = "127.0.0.1:0",
                 discovery_interval: float = 10.0,
                 ignore_tags: Optional[List[TagMatcher]] = None,
                 send_buffer: int = 4096, batch: int = 512,
                 max_workers: int = 8,
                 tls: Optional[GrpcTLS] = None,
                 tls_listen_address: str = "",
                 destination_tls: Optional[GrpcTLS] = None,
                 max_consecutive_failures: int = 3,
                 latency_observatory: bool = True,
                 health_check_interval: float = 2.0,
                 health_check_timeout: float = 1.0,
                 health_unhealthy_after: int = 3,
                 health_healthy_after: int = 2,
                 health_probe: str = "tcp",
                 health_http_url_template: str = "",
                 hedge_after: float = 0.0,
                 failover_walk: int = 2,
                 shard_groups: int = 0,
                 telemetry=None,
                 ledger_enabled: bool = True,
                 ledger_strict: bool = False,
                 ledger_history: int = 32,
                 trace_self_sample_rate: float = 1.0,
                 trace_store_traces: int = 128,
                 trace_store_spans: int = 256,
                 rng: Optional[random.Random] = None):
        self.discoverer = discoverer
        self.forward_service = forward_service
        self.discovery_interval = discovery_interval
        self.shutdown_grace = 1.0  # stop() grace; the CLI overrides it
        # from shutdown_timeout
        self._ignore = list(ignore_tags or [])
        # flight recorder: ejection/readmission (and any future proxy
        # events) land here; the CLI shares this instance with its
        # /metrics registry so the events surface at /debug/events
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        # the latency observatory (core/latency.py): per-destination
        # queue dwell and depth, under the server's knob
        self.latency = LatencyObservatory(enabled=latency_observatory)
        # cross-tier self-tracing (trace/store.py): the proxy follows the
        # interval traces its locals sampled. Incoming trace metadata is
        # continued with proxy.route and proxy.dest.send spans into the
        # store behind this tier's /debug/traces, and re-injected on
        # every destination send (hedges included) so the global keeps
        # the thread. sample_rate gates only the recording of adopted
        # traces, never the pass-through. Span ids come from `rng`.
        self.trace_plane = SelfTracePlane(
            service="veneur-proxy",
            sample_rate=trace_self_sample_rate,
            max_traces=trace_store_traces,
            max_spans=trace_store_spans, rng=rng)
        # flow ledger (core/ledger.py), the proxy's side of the
        # conservation books: routing (received == routed + dropped +
        # no-destination), the destination pool (enqueued == sent +
        # dropped-after-enqueue + queued, retired folds included), and
        # the tier reconciliation against receivers' FlowCounts.
        # Intervals close on the discovery cadence (the proxy has no
        # flush loop).
        self.ledger = FlowLedger(
            enabled=ledger_enabled, strict=ledger_strict,
            history=ledger_history, on_event=self.telemetry.record_event)
        self.ledger.declare(
            "proxy_route", inputs=("proxy.received",),
            outputs=("proxy.routed", "proxy.dropped",
                     "proxy.no_destination"))
        self.ledger.declare(
            "proxy_egress", inputs=("dest.enqueued",),
            outputs=("dest.sent", "dest.dropped_enqueued"),
            stocks=("dest_queues",))
        self.ledger.declare(
            "proxy_tier", inputs=("dest.acked_reported",),
            outputs=("dest.remote_merged", "dest.remote_rejected",
                     "dest.remote_deduped"))
        self.destinations = Destinations(
            send_buffer=send_buffer, batch=batch, tls=destination_tls,
            max_consecutive_failures=max_consecutive_failures,
            observatory=self.latency,
            hedge_after=hedge_after, failover_walk=failover_walk,
            ledger=self.ledger if self.ledger.enabled else None,
            trace_plane=self.trace_plane,
            # shard-aware ring (proxy/ring.py ShardGroupRing): keys
            # shard by digest range onto the shard group serving that
            # range; health ejection re-homes only within the group
            shard_groups=shard_groups)
        # probe the pool's monotonic flow totals (retired folds make
        # them churn-proof) and its live queue depth as a stock. ONE
        # flow_totals() snapshot per close, shared by all four readers:
        # close_interval evaluates probes in registration order and
        # stocks after them, so refreshing on the first (enqueued) read
        # keeps the identity's sides from tearing against each other
        dests = self.destinations
        snap_box = {"snap": None, "t": 0.0}

        def _flow(field: str, refresh: bool = False) -> float:
            now = time.monotonic()
            # 1s freshness bound: a /metrics scrape between closes
            # still reads near-live stock levels, while the close's
            # back-to-back reads stay on one consistent snapshot
            if (refresh or snap_box["snap"] is None
                    or now - snap_box["t"] > 1.0):
                snap_box["snap"] = dests.flow_totals()
                snap_box["t"] = now
            return snap_box["snap"][field]

        self.ledger.probe("dest.enqueued",
                          lambda: _flow("enqueued", refresh=True))
        self.ledger.probe("dest.sent", lambda: _flow("sent"))
        self.ledger.probe("dest.dropped_enqueued",
                          lambda: _flow("dropped_enqueued"))
        self.ledger.stock("dest_queues", lambda: _flow("queued"))
        # active ring health: probes every pool member each round,
        # ejecting/readmitting through the destination pool; membership
        # (DNS/SRV et al) re-resolves on the same cadence via the
        # discovery refresh hook. 0 disables the loop (tests drive
        # run_round() by hand).
        self.ring_health = None
        if health_check_interval > 0:
            self.ring_health = RingHealth(
                self.destinations,
                interval=health_check_interval,
                timeout=health_check_timeout,
                unhealthy_after=health_unhealthy_after,
                healthy_after=health_healthy_after,
                probe=health_probe,
                http_url_template=health_http_url_template,
                refresh=self._refresh_destinations,
                on_event=self.telemetry.record_event)
        # per-RPC latency/error aggregates (reference proxy/grpcstats)
        self.rpc_stats = RpcStats()
        self.stats: Dict[str, int] = {
            "received_total": 0, "routed_total": 0,
            "no_destination_total": 0, "dropped_total": 0,
            "duplicates_dropped_total": 0,
        }
        # idempotency-token dedupe at the PROXY boundary: a local's
        # retry whose first attempt already routed here would otherwise
        # be re-routed with fresh per-destination tokens the global
        # tier can't catch — the exactly-once-per-node property must
        # hold at whichever tier terminates the sender's RPC
        self._deduper = TokenDeduper()
        # identity-key bytes -> (ring POINT, 64-bit key hash): forward
        # streams repeat the same keys every interval, so ring-key
        # derivation (tag filtering, type naming, joining), its ring
        # hash, AND the HLL key hash (per-destination forwarded-key
        # cardinality) are paid once per key lifetime. Points are
        # membership-independent, so the cache survives discovery churn.
        self._route_cache: Dict[bytes, tuple] = {}
        # the upb/V2 path's equivalent, keyed by the derived ring-key
        # string (kept separate: identity-key bytes and derived strings
        # are different namespaces)
        self._v2_route_cache: Dict[str, tuple] = {}
        # handle_metric runs on up to max_workers gRPC threads; python
        # dict += is not atomic, so counter accuracy needs a lock
        self._stats_lock = threading.Lock()
        # routing counters feed the proxy_route identity as probes
        # (per-interval deltas of the already-exact stats table), all
        # read from ONE copy of the table per close: the first probe
        # (received) refreshes it, so a route landing between two probe
        # reads cannot tear the identity (the JAX package reads each
        # counter under its own lock hold)
        stats_box = {"snap": {}}

        def _stat(key: str, refresh: bool = False) -> float:
            if refresh:
                with self._stats_lock:
                    stats_box["snap"] = dict(self.stats)
            return float(stats_box["snap"].get(key, 0))

        for stage, key in (("proxy.received", "received_total"),
                           ("proxy.routed", "routed_total"),
                           ("proxy.dropped", "dropped_total"),
                           ("proxy.no_destination", "no_destination_total"),
                           ("proxy.deduped", "duplicates_dropped_total")):
            self.ledger.probe(stage, lambda k=key: _stat(
                k, refresh=k == "received_total"))
        self._shutdown = threading.Event()
        self._discovery_thread: Optional[threading.Thread] = None

        # the forward client's V1 bulk body scales with key count
        # (~36 MB at 50k digest keys); the 4 MB gRPC default would
        # bounce it at exactly the scale the bulk path exists for
        self._grpc = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            # metadata cap raised past the 8 KiB default, as the JAX
            # package's proxy sets it
            options=[("grpc.max_receive_message_length", 256 << 20),
                     ("grpc.max_metadata_size", 64 << 10)])
        # responses carry FlowCounts (received/routed/duplicate) for
        # the sender's flow-ledger tier reconciliation (forward/wire.py)
        serialize_resp = (lambda b: b if isinstance(b, (bytes, bytearray))
                          else b"")
        handler = grpc.method_handlers_generic_handler("forwardrpc.Forward", {
            "SendMetricsV2": grpc.stream_unary_rpc_method_handler(
                self.rpc_stats.timed("SendMetricsV2", self._send_metrics_v2),
                request_deserializer=metric_pb2.Metric.FromString,
                response_serializer=serialize_resp),
            "SendMetrics": grpc.unary_unary_rpc_method_handler(
                self.rpc_stats.timed("SendMetrics", self._send_metrics_v1),
                # raw bytes: the native route parser re-scatters the
                # body without deserializing; upb is the fallback
                request_deserializer=lambda b: b,
                response_serializer=serialize_resp),
        })
        self._grpc.add_generic_rpc_handlers((handler,))
        # listener layout mirrors the reference v2 proxy (proxy/proxy.go
        # grpc_address + grpc_tls_address): with a dedicated
        # tls_listen_address the server binds BOTH a plaintext port on
        # listen_address and a TLS port there; with tls but no dedicated
        # address, TLS terminates on the single listener (legacy shape);
        # authority => mutual auth either way
        self.tls_port = 0
        if tls_listen_address and not tls:
            # half-configured TLS must fail loudly, never fall back to
            # plaintext (same stance as util/grpctls.py)
            raise ValueError(
                "grpc_tls_address requires tls_certificate/tls_key")
        if tls and tls_listen_address:
            self.tls_port = self._grpc.add_secure_port(
                tls_listen_address, tls.server_credentials())
            if self.tls_port == 0:
                raise RuntimeError(
                    f"could not bind proxy TLS to {tls_listen_address}")
            self.port = self._grpc.add_insecure_port(listen_address)
        elif tls:
            self.port = self._grpc.add_secure_port(
                listen_address, tls.server_credentials())
        else:
            self.port = self._grpc.add_insecure_port(listen_address)
        if self.port == 0:
            raise RuntimeError(f"could not bind proxy to {listen_address}")
        self._listen_host = listen_address.rpartition(":")[0]

    @property
    def address(self) -> str:
        # report the bound host; loopback only for wildcard/empty binds
        # (those aren't dialable as-is)
        host = self._listen_host
        if host in ("", "0.0.0.0", "[::]", "::"):
            host = "127.0.0.1"
        return f"{host}:{self.port}"

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self._refresh_destinations()
        self._grpc.start()
        self._discovery_thread = threading.Thread(
            target=self._discovery_loop, name="proxy-discovery", daemon=True)
        self._discovery_thread.start()
        if self.ring_health is not None:
            self.ring_health.start()
        logger.info("proxy listening on %s (%d destinations)",
                    self.address, self.destinations.size())

    def stop(self, grace: float = 1.0) -> None:
        self._shutdown.set()
        if self.ring_health is not None:
            self.ring_health.stop()
        self._grpc.stop(grace)
        self.destinations.flush_wait(timeout=grace)
        self.destinations.clear()

    def healthy(self) -> bool:
        """False while no destinations are connected (handlers.go:30-38)."""
        return self.destinations.size() > 0

    def ready_state(self):
        """(ready, body) for the proxy's /healthcheck/ready: 503 while
        the ring is empty OR more than half its members are ejected —
        the mirror of the server's shedding semantics (an instance that
        would blackhole most of the keyspace should stop receiving
        traffic). The body always carries the member table so the
        operator sees WHICH globals are sick from the probe itself."""
        members = (self.ring_health.member_table()
                   if self.ring_health is not None else [])
        if not members:
            # no probe round has run yet (or probing is disabled): fall
            # back to pool membership so a healthy just-started proxy
            # doesn't answer 503 for a whole probe interval
            members = [{"address": a, "ejected": False}
                       for a in self.destinations.addresses()]
        total = len(members)
        ejected = sum(1 for m in members if m.get("ejected"))
        body = {"destinations": total, "ejected": ejected,
                "members": members}
        groups = self.destinations.group_table()
        if groups:
            body["shard_groups"] = groups
        if total == 0:
            body["reason"] = "no destinations connected"
            return False, body
        if ejected * 2 > total:
            body["reason"] = (f"{ejected}/{total} ring members ejected "
                              "(>50%)")
            return False, body
        # a shard group with no live members has lost its whole key
        # range to clockwise spill: those keys merge on instances that
        # don't serve their device-shard range — degraded enough that
        # orchestrators should stop routing here
        dead = [g["group"] for g in groups if not g["live"]]
        if dead:
            body["reason"] = (f"shard group(s) {dead} have no live "
                              "members (key ranges spilling)")
            return False, body
        return True, body

    def telemetry_rows(self) -> List[tuple]:
        """Scrape-time rows for /metrics: routing counters plus the
        per-destination pool/breaker rows (proxy.dest.*,
        resilience.breaker_state)."""
        with self._stats_lock:
            rows = [(f"proxy.{key}", "counter", float(value), ())
                    for key, value in self.stats.items()]
        rows.append(("proxy.destinations", "gauge",
                     float(self.destinations.size()), ()))
        rows.extend(self.destinations.telemetry_rows())
        if self.ring_health is not None:
            rows.extend(self.ring_health.telemetry_rows())
        rows.extend(self.latency.telemetry_rows())
        rows.extend(self.trace_plane.telemetry_rows())
        rows.extend(self.ledger.telemetry_rows())
        return rows

    def cardinality_report(self, top: int = 20, name: str = "") -> dict:
        """/debug/cardinality on the proxy tier: per-destination
        forwarded-key HLL estimates (cumulative per destination
        lifetime), so an operator can see which global instance a key
        explosion hashes onto. `name` filters to one destination
        address; `top` bounds the list (largest key count first)."""
        with self.destinations._lock:
            pool = list(self.destinations._pool.values())
        dests = []
        for dest in pool:
            if name and dest.address != name:
                continue
            dests.append({
                "address": dest.address,
                "forwarded_keys_estimate": int(dest.key_hll.estimate()),
                "sent_total": dest.sent_total,
                "dropped_total": dest.dropped_total,
                "queue_depth": dest._queue.qsize(),
                "breaker_state": dest.breaker.state,
            })
        dests.sort(key=lambda d: d["forwarded_keys_estimate"],
                   reverse=True)
        with self._stats_lock:
            stats = dict(self.stats)
        return {
            "generated_unix": round(time.time(), 3),
            "routing": stats,
            "route_cache_size": (len(self._route_cache)
                                 + len(self._v2_route_cache)),
            "destinations": dests[:max(0, top)],
        }

    # -- discovery -------------------------------------------------------

    def _discovery_loop(self) -> None:
        while not self._shutdown.wait(self.discovery_interval):
            self._refresh_destinations()
            # ledger intervals ride the discovery cadence — the proxy
            # has no flush loop, and ~10s matches the server's interval
            try:
                self.ledger.close_interval()
            except LedgerImbalance:
                # strict mode on a live proxy: the imbalance is loud
                # (ERROR + traceback + the ledger_imbalance event the
                # close already recorded) but must not kill the
                # discovery/health-refresh thread it shares
                logger.exception("proxy flow-ledger conservation breach "
                                 "(ledger_strict)")
            except Exception:
                logger.exception("proxy ledger close failed")

    def _refresh_destinations(self) -> None:
        try:
            addresses = self.discoverer.get_destinations_for_service(
                self.forward_service)
        except Exception:
            logger.exception("discovery failed for %s; keeping current pool",
                             self.forward_service)
            return
        if not addresses:
            # an empty result is treated as a discovery outage: keep
            # forwarding to the known pool rather than dropping everything
            logger.warning("discovery returned no destinations for %s",
                           self.forward_service)
            return
        self.destinations.set_destinations(addresses)

    ROUTE_CACHE_MAX = 1_000_000

    # -- cross-tier self-tracing -----------------------------------------

    def _trace_begin(self, ctx):
        """Continue a local's interval trace through the routing tier:
        follow the incoming id (sample-gated for recording only), open
        the proxy.route span, and hand the lineage and the exemplar
        sidecar to the destination pool, whose senders re-inject them on
        their next batch. An untraced RPC clears the pool's lineage. Runs
        only after the token dedupe passed."""
        trace_id, span_id = extract_trace(ctx)
        if not trace_id:
            self.destinations.note_trace(0, 0, None)
            return None
        blob = metadata_value(ctx, EXEMPLAR_KEY)
        span = (self.trace_plane.span("proxy.route", trace_id,
                                      parent_id=span_id)
                if self.trace_plane.follow(trace_id) else None)
        # downstream parent: the route span when recorded here, else the
        # sender's span (the chain stays connected either way)
        self.destinations.note_trace(
            trace_id, span.id if span is not None else span_id, blob)
        return span

    @staticmethod
    def _trace_end(span, received: int, routed: int, ok: bool) -> None:
        if span is None:
            return
        span.set_tag("received", received)
        span.set_tag("routed", routed)
        if not ok:
            span.error()
        span.finish()

    # -- handlers --------------------------------------------------------

    def _send_metrics_v1(self, body, ctx):
        token, disposition = self._deduper.begin(ctx)
        if disposition == "done":
            with self._stats_lock:
                self.stats["duplicates_dropped_total"] += 1
            return encode_flow_counts(0, 0, duplicate=True)
        if disposition == "inflight":
            ctx.abort(grpc.StatusCode.UNAVAILABLE,
                      "duplicate send racing its first attempt")
        ok = False
        received = routed = 0
        tspan = None
        try:
            tspan = self._trace_begin(ctx)
            # a replayed interval's x-veneur-interval stamp must survive
            # the routing hop, or the global folds hours-stale history
            # into its live flush
            interval = extract_interval(ctx)
            res = self._route_native(body, interval=interval)
            if res is None:
                metric_list = forward_pb2.MetricList.FromString(body)
                for pbm in metric_list.metrics:
                    received += 1
                    if self.handle_metric(pbm, interval=interval):
                        routed += 1
            else:
                received, routed = res
            ok = True
        finally:
            self._deduper.end(token, ok)
            self._trace_end(tspan, received, routed, ok)
        # FlowCounts back to the local: received metrics this handler
        # parsed, "merged" = routed onto a destination queue (drops and
        # no-destination are this proxy's accounted loss)
        return encode_flow_counts(received, routed)

    def _route_native(self, body, interval: float = 0.0
                      ) -> Optional[tuple]:
        """Re-scatter a V1 body without deserializing: the native walk
        (vnt_route_parse) yields each metric's identity key + raw bytes;
        the ring key derives from the identity key once per key lifetime
        (the route cache) and destinations forward the raw bytes — both
        V1 framing and the V2 stream serializer pass bytes through.
        Returns (received, routed) for the FlowCounts response, or None
        when the native walker cannot parse the body (the caller's upb
        parse then raises the same rejection)."""
        parsed = native.route_parse(body)
        if parsed is None:
            return None
        keys, raws = parsed
        cache = self._route_cache
        fast = routed = dropped = no_dest = 0
        slow = slow_routed = 0
        try:
            for key, raw in zip(keys, raws):
                if not key:
                    # wide open enum: the upb path decides (and raises
                    # the same way the stream path would); it also does
                    # its own received/routed accounting
                    slow += 1
                    if self.handle_metric(
                            metric_pb2.Metric.FromString(raw)):
                        slow_routed += 1
                    continue
                fast += 1
                cached = cache.get(key)
                if cached is None:
                    # strict decode: invalid utf-8 raises here, and the
                    # upb re-parse below surfaces the same rejection the
                    # old whole-body deserializer gave — the poisoned
                    # metric never reaches a destination batch
                    try:
                        mtype, _scope, name, tags = \
                            native.decode_import_key(key)
                        type_name = metric_pb2.Type.Name(mtype).lower()
                    except (ValueError, IndexError):
                        fast -= 1  # slow path does its own accounting
                        slow += 1
                        if self.handle_metric(
                                metric_pb2.Metric.FromString(raw)):
                            slow_routed += 1
                        continue
                    tags = [t for t in tags
                            if not any(mm.match(t) for mm in self._ignore)]
                    ring_key = "%s%s%s" % (name, type_name, ",".join(tags))
                    point = self.destinations.ring.point_of(ring_key)
                    if len(cache) >= self.ROUTE_CACHE_MAX:
                        cache.clear()
                    # HLL key hash over the DERIVED ring key — the same
                    # basis handle_metric hashes, so forwarded-key
                    # estimates agree across ingest paths — paid once
                    # per key lifetime
                    cached = cache[key] = (
                        point, hll_ref.hash_member(ring_key.encode()))
                point, key_hash = cached
                try:
                    dest = self.destinations.get_at(point)
                except EmptyRingError:
                    no_dest += 1
                    continue
                dest.note_key(key_hash)
                if dest.send(raw, interval=interval):
                    routed += 1
                else:
                    dropped += 1
        finally:
            # flushed even when a slow-path metric raises mid-batch so
            # already-forwarded metrics stay counted
            with self._stats_lock:
                self.stats["received_total"] += fast
                self.stats["routed_total"] += routed
                self.stats["dropped_total"] += dropped
                self.stats["no_destination_total"] += no_dest
        return fast + slow, routed + slow_routed

    def _send_metrics_v2(self, request_iterator, ctx):
        token, disposition = self._deduper.begin(ctx)
        if disposition == "done":
            with self._stats_lock:
                self.stats["duplicates_dropped_total"] += 1
            for _ in request_iterator:  # complete the sender's stream
                pass
            return encode_flow_counts(0, 0, duplicate=True)
        if disposition == "inflight":
            ctx.abort(grpc.StatusCode.UNAVAILABLE,
                      "duplicate send racing its first attempt")
        ok = False
        received = routed = 0
        tspan = None
        try:
            tspan = self._trace_begin(ctx)  # see _send_metrics_v1
            interval = extract_interval(ctx)
            for pbm in request_iterator:
                received += 1
                if self.handle_metric(pbm, interval=interval):
                    routed += 1
            ok = True
        finally:
            self._deduper.end(token, ok)
            self._trace_end(tspan, received, routed, ok)
        return encode_flow_counts(received, routed)

    def handle_metric(self, pbm: metric_pb2.Metric,
                      interval: float = 0.0) -> bool:
        """Route one metric (handlers.go:100-164): hash key is
        name + lowercase type + joined tags minus ignored tags.
        Returns True when the metric landed on a destination queue
        (the FlowCounts "merged" figure for this tier). `interval`
        carries the sender's x-veneur-interval stamp through to the
        destination batch (WAL replay timestamp fidelity)."""
        with self._stats_lock:
            self.stats["received_total"] += 1
        tags = [t for t in pbm.tags
                if not any(matcher.match(t) for matcher in self._ignore)]
        key = "%s%s%s" % (pbm.name,
                          metric_pb2.Type.Name(pbm.type).lower(),
                          ",".join(tags))
        # same once-per-key-lifetime amortization as the native path:
        # the ring hash and the HLL key hash are both pure-Python and
        # both repeat every interval for a steady key stream
        cached = self._v2_route_cache.get(key)
        if cached is None:
            if len(self._v2_route_cache) >= self.ROUTE_CACHE_MAX:
                self._v2_route_cache.clear()
            cached = self._v2_route_cache[key] = (
                self.destinations.ring.point_of(key),
                hll_ref.hash_member(key.encode()))
        point, key_hash = cached
        try:
            dest = self.destinations.get_at(point)
        except EmptyRingError:
            with self._stats_lock:
                self.stats["no_destination_total"] += 1
            return False
        dest.note_key(key_hash)
        routed = dest.send(pbm, interval=interval)
        with self._stats_lock:
            self.stats["routed_total" if routed else "dropped_total"] += 1
        return routed


def create_static_proxy(destination_addresses: List[str],
                        **kwargs) -> ProxyServer:
    return ProxyServer(StaticDiscoverer(destination_addresses), **kwargs)
