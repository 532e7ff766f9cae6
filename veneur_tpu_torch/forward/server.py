"""Import server: the gRPC /forwardrpc.Forward endpoint of a global server
(port of the core of veneur_tpu/forward/server.py; reference
sources/proxy/server.go:26-161).

It receives the locals' forwarded state, interns the keys into the owning
server's column store and merges it there, on that server's device:
counter add (host float64), gauge overwrite, digest recompress, HLL
register max, llhist register add (reference worker.go:410-467).

* SendMetrics (V1, one MetricList body) decodes natively
  (native.parse_metric_list: identity keys, pre-bucketed centroid grids)
  through a stub cache, sweeps the llhist rows the C parser skips with
  upb, and parses a body the C parser rejects with upb.
* SendMetricsV2 (a stream of Metrics) buffers per family (_MergeBuffer)
  and merges in few large table calls.

Both answer with FlowCounts and drop a repeated idempotency token. A merge
that raises answers INTERNAL and is counted in `errors`; it is never
acknowledged.

An import stamped (`x-veneur-interval`) with an interval older than the
owning server's `backfill_after_s` (a WAL or spool replay of a
historical interval) merges into the server's backfill plane
(forward/backfill.py), bucketed by its original interval, instead of the
live tables. Tags matching `ignored_tags` (the server's `tags_exclude`
prefixes) are stripped from every imported metric before its identity is
hashed. Trace spans, the peer-shard gauge, TLS and RPC stats are not
ported yet.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent import futures
from typing import Dict, List, Optional

import grpc
import numpy as np

from veneur_tpu_torch import native
from veneur_tpu_torch.forward import hllwire, llhistwire
from veneur_tpu_torch.forward.convert import (_SCOPE_FROM_PB,
                                              _TYPE_PB_TO_NAME,
                                              import_scope,
                                              metric_key_of_proto)
from veneur_tpu_torch.forward.protos import forward_pb2, metric_pb2
from veneur_tpu_torch.forward.wire import (TokenDeduper, encode_flow_counts,
                                           extract_interval)
from veneur_tpu_torch.ops import batch_tdigest, hll_ref
from veneur_tpu_torch.samplers.metrics import (MetricKey, MetricScope,
                                               UDPMetric, update_tags)

logger = logging.getLogger("veneur_tpu_torch.forward.server")

# a V1 MetricList at tens of thousands of digest keys is tens of MB
MAX_MESSAGE_BYTES = 256 << 20
FAMILIES = ("counter", "gauge", "histogram", "set", "llhist")


def _raw(b):
    return b


class ImportServer:
    """Owned by a global `Server` (`server.store` is where merges land;
    `server.backfill` and `server.backfill_after_s`, when present, route
    stale stamped imports). `imported_total` counts metrics received and
    `v1_bytes` the bytes of the V1 bodies; `merge_s` holds the cumulative
    wall seconds of each family's merges (each synchronised with the
    device before it is counted), of the V1 native parse, of the V1
    keys' stub lookups and of the backfill merges."""

    STUB_CACHE_MAX = 1_000_000

    def __init__(self, server, address: str = "127.0.0.1:0",
                 ignored_tags: Optional[List] = None):
        self._server = server
        # TagMatchers (util/matcher.py) of tags stripped on import
        self._ignored = list(ignored_tags or [])
        self._grpc = grpc.server(
            futures.ThreadPoolExecutor(max_workers=4),
            options=[("grpc.max_receive_message_length",
                      MAX_MESSAGE_BYTES)])
        handler = grpc.method_handlers_generic_handler("forwardrpc.Forward", {
            "SendMetricsV2": grpc.stream_unary_rpc_method_handler(
                self._send_metrics_v2,
                request_deserializer=metric_pb2.Metric.FromString,
                response_serializer=_raw),
            "SendMetrics": grpc.unary_unary_rpc_method_handler(
                self._send_metrics_v1,
                # raw bytes: the native MetricList decoder wants the body
                request_deserializer=_raw,
                response_serializer=_raw),
        })
        self._grpc.add_generic_rpc_handlers((handler,))
        self.port = self._grpc.add_insecure_port(address)
        if self.port == 0:
            raise RuntimeError(f"could not bind import server to {address}")
        self._host = address.rsplit(":", 1)[0]
        self._lock = threading.Lock()
        self.imported_total = 0
        self.v1_bytes = 0
        self.errors = 0
        self.merge_s: Dict[str, float] = {f: 0.0 for f in FAMILIES}
        self.merge_s["parse"] = 0.0
        self.merge_s["stubs"] = 0.0
        self.merge_s["backfill"] = 0.0
        # identity key -> UDPMetric stub: forward streams repeat the same
        # keys every interval, so update_tags/fnv run once per key
        self._stub_cache: dict = {}
        self._deduper = TokenDeduper()

    @property
    def address(self) -> str:
        return f"{self._host}:{self.port}"

    @property
    def duplicates_dropped_total(self) -> int:
        return self._deduper.duplicates_dropped_total

    def telemetry_rows(self) -> List[tuple]:
        """Scrape-time rows for the owning server's /metrics registry
        (the JAX package's, less the peer-shard gauge)."""
        return [("forward.hedge.duplicates_dropped", "counter",
                 float(self.duplicates_dropped_total), ())]

    def start(self) -> None:
        self._grpc.start()
        logger.info("import server listening on %s", self.address)

    def stop(self, grace: float = 1.0) -> None:
        self._grpc.stop(grace).wait()

    # -- handlers --------------------------------------------------------

    def _import(self, ctx, merge) -> bytes:
        """The RPC frame both handlers share: token dedupe, the merge
        (returning (received, merged)), the accounting, and an INTERNAL
        status for a merge that raised."""
        token, disposition = self._deduper.begin(ctx)
        if disposition == "done":
            logger.info("dropping duplicate import (token %s)", token)
            return None
        if disposition == "inflight":
            # the first attempt may yet fail: make the sender try again
            ctx.abort(grpc.StatusCode.UNAVAILABLE,
                      "duplicate import racing its first attempt")
        ok = False
        try:
            received, merged = merge()
            ok = True
        except Exception as e:
            with self._lock:
                self.errors += 1
            logger.exception("import merge failed")
            ctx.abort(grpc.StatusCode.INTERNAL,
                      f"import merge failed: {type(e).__name__}: {e}")
        finally:
            self._deduper.end(token, ok)
        with self._lock:
            self.imported_total += received
        return encode_flow_counts(received, merged)

    def _send_metrics_v1(self, body, ctx):
        """Unary MetricList import, the bulk path: one body parsed in C
        is far cheaper than tens of thousands of stream messages. The
        reference importer retired this endpoint
        (sources/proxy/server.go:138-142); its proxy still accepts it."""
        stale_iv = self._stale_interval(ctx)
        if stale_iv:
            def merge():
                with self._lock:
                    self.v1_bytes += len(body)
                return self._merge_backfill(
                    forward_pb2.MetricList.FromString(body).metrics,
                    stale_iv)
        else:
            def merge():
                return self._merge_v1(body)
        resp = self._import(ctx, merge)
        return (encode_flow_counts(0, 0, duplicate=True) if resp is None
                else resp)

    def _send_metrics_v2(self, request_iterator, ctx):
        stale_iv = self._stale_interval(ctx)

        def merge():
            if stale_iv:
                return self._merge_backfill(request_iterator, stale_iv)
            buf = _MergeBuffer(self)
            count = 0
            for pbm in request_iterator:
                buf.add(pbm)
                count += 1
            buf.flush_all()
            return count, buf.admitted
        resp = self._import(ctx, merge)
        if resp is None:
            # drain without merging so the sender's stream completes
            for _ in request_iterator:
                pass
            return encode_flow_counts(0, 0, duplicate=True)
        return resp

    # -- timestamp-faithful backfill --------------------------------------

    def _stale_interval(self, ctx) -> float:
        """The RPC's interval stamp when it names an interval old enough
        to backfill (and the owning server runs a backfill plane); 0.0
        routes the import to the live tables. Live forwards carry no
        stamp, so only WAL and spool replays of historical intervals
        divert."""
        if getattr(self._server, "backfill", None) is None:
            return 0.0
        stale_after = getattr(self._server, "backfill_after_s", 0.0)
        if stale_after <= 0:
            return 0.0
        iv = extract_interval(ctx)
        if iv > 0 and time.time() - iv >= stale_after:
            return iv
        return 0.0

    def _merge_backfill(self, metrics, iv: float) -> tuple:
        """Merge upb Metrics into the backfill plane's interval buckets
        instead of the live tables: the per-metric field-11 stamp picks
        the bucket, the RPC stamp is the fallback. Returns (received,
        merged) for the FlowCounts response."""
        t0 = time.perf_counter()
        plane = self._server.backfill
        received = merged = 0
        for pbm in metrics:
            received += 1
            if plane.merge_proto(pbm, iv):
                merged += 1
        with self._lock:
            self.merge_s["backfill"] += time.perf_counter() - t0
        return received, merged

    # -- merges ------------------------------------------------------------

    def _timed(self, family: str, fn, *args) -> None:
        """Run one family's merge and synchronise the device, so that the
        merge's failure raises here (and the RPC answers it) and its time
        is the merge's, not its enqueue."""
        t0 = time.perf_counter()
        fn(*args)
        self._server.store.synchronize()
        with self._lock:
            self.merge_s[family] += time.perf_counter() - t0

    def _merge_v1(self, body) -> tuple:
        """(received, merged) of one V1 body: native parse, or upb for a
        body the C parser rejects."""
        t0 = time.perf_counter()
        batch = native.parse_metric_list(
            body, batch_tdigest.C, batch_tdigest.COMPRESSION)
        with self._lock:
            self.merge_s["parse"] += time.perf_counter() - t0
            self.v1_bytes += len(body)
        if batch is None:
            req = forward_pb2.MetricList.FromString(body)
            buf = _MergeBuffer(self)
            for pbm in req.metrics:
                buf.add(pbm)
            buf.flush_all()
            return len(req.metrics), buf.admitted
        return batch.consumed, self._merge_native(body, batch)

    def _merge_native(self, body, batch) -> int:
        """Merge a parsed V1 body; returns the metrics offered to the
        store (the `merged` of the FlowCounts response)."""
        store = self._server.store
        merged = 0
        if batch.c_keys:
            stubs, ok = self._stubs_for(batch.c_keys)
            if stubs:
                self._timed("counter", store.counters.merge_batch, stubs,
                            batch.c_vals[ok])
                merged += len(stubs)
        if batch.g_keys:
            stubs, ok = self._stubs_for(batch.g_keys)
            if stubs:
                self._timed("gauge", store.gauges.merge_batch, stubs,
                            batch.g_vals[ok])
                merged += len(stubs)
        if batch.h_keys:
            stubs, ok = self._stubs_for(batch.h_keys)
            if stubs:
                self._timed("histogram", store.histos.merge_batch, stubs,
                            batch.h_means[ok], batch.h_weights[ok],
                            batch.h_min[ok], batch.h_max[ok],
                            batch.h_recip[ok])
                merged += len(stubs)
        if batch.s_keys:
            stubs, ok = self._stubs_for(batch.s_keys)
            payloads = [p for p, use in zip(batch.s_payloads, ok) if use]
            regs, keep = [], []
            for stub, payload in zip(stubs, payloads):
                r = _decode_hll(payload)
                if r is not None:
                    regs.append(r)
                    keep.append(stub)
            if regs:
                self._timed("set", store.sets.merge_batch, keep,
                            np.stack(regs))
                merged += len(regs)
        return merged + self._merge_unknown_families(body, batch)

    def _merge_unknown_families(self, body, batch) -> int:
        """upb sweep behind the native V1 parser for the family it does
        not decode (llhist): the C parser skips an unknown value field,
        so whenever it consumed more metrics than it emitted, re-parse
        the body with upb and merge just the llhist rows. Returns the
        rows merged."""
        emitted = (len(batch.c_keys) + len(batch.g_keys)
                   + len(batch.h_keys) + len(batch.s_keys))
        if emitted >= batch.consumed:
            return 0
        req = forward_pb2.MetricList.FromString(body)
        buf = _MergeBuffer(self)
        for pbm in req.metrics:
            if pbm.WhichOneof("value") == "llhist":
                buf.add(pbm)
        buf.flush_all()
        return buf.admitted

    def _stubs_for(self, keys):
        """Identity keys -> UDPMetric stubs through the intern cache.
        Returns (stubs, keep-mask): keys that do not map (unknown type
        enum, local scope, bad utf-8) drop out of the mask."""
        t0 = time.perf_counter()
        cache = self._stub_cache
        stubs = []
        ok = np.ones(len(keys), bool)
        for i, key in enumerate(keys):
            stub = cache.get(key)
            if stub is None:
                stub = self._build_stub(key)
                if stub is None:
                    ok[i] = False
                    continue
                if len(cache) >= self.STUB_CACHE_MAX:
                    # crude wholesale bound: the cache refills from the
                    # live key set within one interval
                    logger.warning("import stub cache cleared at %d "
                                   "entries", len(cache))
                    cache.clear()
                cache[key] = stub
            stubs.append(stub)
        with self._lock:
            self.merge_s["stubs"] += time.perf_counter() - t0
        return stubs, ok

    def _build_stub(self, key: bytes) -> Optional[UDPMetric]:
        try:
            mtype, scope_pb, name, tags = native.decode_import_key(key)
        except (IndexError, ValueError):
            return None
        type_name = _TYPE_PB_TO_NAME.get(mtype)
        if type_name is None:
            logger.warning("unknown metric type %s for %r; skipped",
                           mtype, name)
            return None
        if mtype in (metric_pb2.Counter, metric_pb2.Gauge):
            scope = MetricScope.GLOBAL_ONLY  # import coercion
        else:
            scope = _SCOPE_FROM_PB.get(scope_pb, MetricScope.MIXED)
        if scope == MetricScope.LOCAL_ONLY:
            logger.warning("gRPC import does not accept local metrics")
            return None
        tags = [t for t in tags
                if not any(im.match(t) for im in self._ignored)]
        final, joined, h32, h64 = update_tags(name, type_name, tags, None)
        return UDPMetric(key=MetricKey(name, type_name, joined),
                         digest=h32, digest64=h64, tags=list(final),
                         scope=scope)


class _MergeBuffer:
    """Per-family accumulation of one import request, merged in as few
    table calls as possible. Caps bound transient memory on an unbounded
    stream: a buffered digest is ~2.5 KB, a set 16 KB, an llhist row ~36
    KB of int64 bins, a scalar a ~100 B stub."""

    HISTO_CAP = 16384
    SCALAR_CAP = 65536
    SET_CAP = 4096
    LLHIST_CAP = 4096

    def __init__(self, srv: ImportServer):
        self._srv = srv
        self._store = srv._server.store
        self.c_stubs: List[UDPMetric] = []
        self.c_vals: list = []
        self.g_stubs: List[UDPMetric] = []
        self.g_vals: list = []
        self.h_stubs: List[UDPMetric] = []
        self.h_means, self.h_weights = [], []
        self.h_min, self.h_max, self.h_recip = [], [], []
        self.s_stubs: List[UDPMetric] = []
        self.s_regs: list = []
        self.l_stubs: List[UDPMetric] = []
        self.l_bins: list = []
        # metrics accepted into a family buffer (vs skipped: no value,
        # local scope, unknown type, undecodable payload): the `merged`
        # of the FlowCounts response
        self.admitted = 0

    def add(self, pbm: metric_pb2.Metric) -> None:
        which = pbm.WhichOneof("value")
        if which is None:
            logger.warning("can't import a metric with no value: %s",
                           pbm.name)
            return
        scope = import_scope(pbm)
        if scope == MetricScope.LOCAL_ONLY:
            logger.warning("gRPC import does not accept local metrics")
            return
        try:
            key, h32, h64, tags = metric_key_of_proto(pbm,
                                                      self._srv._ignored)
        except KeyError:
            # open proto3 enums: a newer peer may send unknown types
            logger.warning("unknown metric type %s for %r; skipped",
                           pbm.type, pbm.name)
            return
        stub = UDPMetric(key=key, digest=h32, digest64=h64,
                         tags=list(tags), scope=scope)
        if which == "counter":
            self.admitted += 1
            self.c_stubs.append(stub)
            self.c_vals.append(float(pbm.counter.value))
            if len(self.c_stubs) >= self.SCALAR_CAP:
                self._flush_counters()
        elif which == "gauge":
            self.admitted += 1
            self.g_stubs.append(stub)
            self.g_vals.append(pbm.gauge.value)
            if len(self.g_stubs) >= self.SCALAR_CAP:
                self._flush_gauges()
        elif which == "histogram":
            d = pbm.histogram.t_digest
            if not d.main_centroids:
                # an empty digest carries no samples; merging it would
                # still clobber the row's min/max with default zeros
                return
            n = len(d.main_centroids)
            self.admitted += 1
            self.h_stubs.append(stub)
            self.h_means.append(np.fromiter(
                (c.mean for c in d.main_centroids), np.float64, n))
            self.h_weights.append(np.fromiter(
                (c.weight for c in d.main_centroids), np.float64, n))
            self.h_min.append(d.min)
            self.h_max.append(d.max)
            self.h_recip.append(d.reciprocalSum)
            if len(self.h_stubs) >= self.HISTO_CAP:
                self._flush_histos()
        elif which == "set":
            regs = _decode_hll(pbm.set.hyper_log_log)
            if regs is not None:
                self.admitted += 1
                self.s_stubs.append(stub)
                self.s_regs.append(regs)
                if len(self.s_stubs) >= self.SET_CAP:
                    self._flush_sets()
        elif which == "llhist":
            try:
                bins = llhistwire.unmarshal(pbm.llhist.bins)
            except llhistwire.LLHistWireError as e:
                logger.warning("undecodable llhist payload (%d bytes) "
                               "dropped: %s", len(pbm.llhist.bins), e)
                return
            self.admitted += 1
            self.l_stubs.append(stub)
            self.l_bins.append(bins)
            if len(self.l_stubs) >= self.LLHIST_CAP:
                self._flush_llhists()

    def _flush_counters(self):
        self._srv._timed("counter", self._store.counters.merge_batch,
                         self.c_stubs, self.c_vals)
        self.c_stubs, self.c_vals = [], []

    def _flush_gauges(self):
        self._srv._timed("gauge", self._store.gauges.merge_batch,
                         self.g_stubs, self.g_vals)
        self.g_stubs, self.g_vals = [], []

    def _flush_histos(self):
        pm, pw = batch_tdigest.pack_centroids_many(self.h_means,
                                                   self.h_weights)
        self._srv._timed("histogram", self._store.histos.merge_batch,
                         self.h_stubs, pm, pw, self.h_min, self.h_max,
                         self.h_recip)
        self.h_stubs, self.h_means, self.h_weights = [], [], []
        self.h_min, self.h_max, self.h_recip = [], [], []

    def _flush_sets(self):
        self._srv._timed("set", self._store.sets.merge_batch, self.s_stubs,
                         np.stack(self.s_regs))
        self.s_stubs, self.s_regs = [], []

    def _flush_llhists(self):
        self._srv._timed("llhist", self._store.llhists.merge_batch,
                         self.l_stubs, np.stack(self.l_bins))
        self.l_stubs, self.l_bins = [], []

    def flush_all(self):
        if self.c_stubs:
            self._flush_counters()
        if self.g_stubs:
            self._flush_gauges()
        if self.h_stubs:
            self._flush_histos()
        if self.s_stubs:
            self._flush_sets()
        if self.l_stubs:
            self._flush_llhists()


def _decode_hll(data: bytes) -> Optional[np.ndarray]:
    """Decode a forwarded HLL payload: the axiomhq binary format a Go
    veneur sends (sparse or dense, reference samplers.go:299-311), or a
    raw 16384-byte register dump."""
    if len(data) == hll_ref.M:
        return np.frombuffer(data, np.int8)
    try:
        regs, p = hllwire.unmarshal(data)
    except hllwire.HLLWireError as e:
        logger.warning("undecodable HLL payload (%d bytes) dropped: %s",
                       len(data), e)
        return None
    if p != hll_ref.P:
        logger.warning("HLL precision %d != %d; payload dropped",
                       p, hll_ref.P)
        return None
    return regs.astype(np.int8)
