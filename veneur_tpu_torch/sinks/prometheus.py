"""Prometheus sink: statsd-exporter repeater or embedded exposition.

Behavioral parity with reference sinks/prometheus/prometheus.go (165 LoC):
two modes —
- repeater: re-emit each InterMetric as a statsd line to a
  statsd_exporter address (UDP/TCP),
- embedded exposition: serve the last flush in Prometheus text format on
  a local HTTP port for scraping.

Copied from veneur_tpu/sinks/prometheus.py. Exemplars come from the owning
server's `trace_plane`, which the port does not have yet, so a port
server renders none.
"""

from __future__ import annotations

import logging
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from veneur_tpu_torch.protocol.render import render_metric_packet
from veneur_tpu_torch.samplers.metrics import InterMetric, MetricType
from veneur_tpu_torch.sinks import MetricSink, register_metric_sink
from veneur_tpu_torch.sinks.cortex import sanitize_label, sanitize_name

logger = logging.getLogger("veneur_tpu_torch.sinks.prometheus")


def escape_label_value(v: str) -> str:
    """Exposition-format label-value escaping: backslash, double-quote,
    and line-feed (in that order — backslash first, or the escapes
    would double-escape). Round-trips through
    sources.openmetrics.parse_exposition."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def exemplar_clause_for(m: InterMetric, exemplars, exemplified) -> str:
    """The OpenMetrics exemplar clause for one exposition line, or ''.
    Shared contract with the Cortex sink: COUNTER lines only (exemplars
    on gauges are invalid OpenMetrics), at most one line per exemplar
    BASE name (`exemplified` accumulates across the flush), and a
    suffix-resolved exemplar attaches only to its `.bucket` family —
    rendered cumulative smallest-le first, so the first bucket whose
    bound contains the value (for_series' le check) is the tightest,
    per the OpenMetrics contract. An exact-name entry (a heavy-hitter
    counter) attaches to its own line."""
    if exemplars is None or m.type != MetricType.COUNTER:
        return ""
    from veneur_tpu_torch.trace.store import exemplar_base
    base = exemplar_base(m.name)
    if base in exemplified:
        return ""
    if base != m.name and m.name != base + ".bucket":
        return ""
    try:
        clause = exemplars(m.name, m.tags) or ""
    except Exception:
        return ""
    if clause:
        exemplified.add(base)
    return clause


def render_exposition(metrics: List[InterMetric],
                      exemplars=None, openmetrics: bool = False) -> str:
    """Prometheus text exposition; with an exemplar source (the
    self-trace plane's `exemplar_for`, trace/store.py) counter lines
    gain the OpenMetrics exemplar clause
    `... # {trace_id="..."} value ts` per exemplar_clause_for's
    one-per-family tightest-bucket rules. `openmetrics` switches
    timestamp units: text 0.0.4 stamps milliseconds, OpenMetrics
    stamps seconds."""
    lines = []
    exemplified = set()
    for m in metrics:
        if m.type == MetricType.STATUS:
            continue
        labels = []
        for t in m.tags:
            k, _, v = t.partition(":")
            labels.append(f'{sanitize_label(k)}="{escape_label_value(v)}"')
        label_str = "{" + ",".join(labels) + "}" if labels else ""
        clause = exemplar_clause_for(m, exemplars, exemplified)
        # backfilled series (WAL replay of a historical interval) carry
        # an explicit exposition timestamp — their value belongs to the
        # ORIGINAL interval, not scrape time. Live series stay
        # timestamp-free, the usual exposition contract.
        if m.backfilled:
            stamp = (f" {int(m.timestamp)}" if openmetrics
                     else f" {int(m.timestamp) * 1000}")
        else:
            stamp = ""
        lines.append(f"{sanitize_name(m.name)}{label_str} {m.value}"
                     f"{stamp}{clause}")
    return "\n".join(lines) + ("\n" if lines else "")


class PrometheusMetricSink(MetricSink):
    def __init__(self, name: str, repeater_address: str = "",
                 network: str = "udp", expose_address: str = ""):
        self._name = name
        self.repeater_address = repeater_address
        self.network = network
        self.expose_address = expose_address
        # plain 0.0.4 is pre-rendered per flush (the common scrape);
        # the OpenMetrics variant (exemplar clauses + EOF) renders
        # LAZILY on the first openmetrics-negotiated scrape and is
        # cached until the next flush — a mid-line `#` would break
        # 0.0.4 parsers, and most deployments never request OM
        self._exposition = ""
        self._exposition_om: Optional[str] = None
        self._om_metrics: List[InterMetric] = []
        self._om_batch = None  # FlushBatch behind the lazy OM render
        self._renderer = None  # PrometheusColumnarRenderer, built lazily
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        # OpenMetrics exemplars: the owning server's self-trace plane
        # (captured in start()) annotates matching exposition lines
        # with the interval trace that produced the value
        self._exemplars = None

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "prometheus"

    def start(self, server) -> None:
        self.bind_server(server)
        plane = getattr(server, "trace_plane", None)
        if plane is not None:
            self._exemplars = plane.exemplar_for
        if not self.expose_address:
            return
        host, _, port = self.expose_address.rpartition(":")
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802
                want_om = "openmetrics" in (self.headers.get("Accept")
                                            or "")
                body = (sink.exposition_openmetrics() if want_om
                        else sink.exposition_plain()).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8" if want_om
                    else "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host or "127.0.0.1", int(port)),
                                          Handler)
        threading.Thread(target=self._httpd.serve_forever,
                         name="prometheus-expose", daemon=True).start()

    @property
    def expose_port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    def exposition_plain(self) -> str:
        with self._lock:
            return self._exposition

    def exposition_openmetrics(self) -> str:
        """The OM variant for the last flush, rendered on first demand
        and cached until the next flush invalidates it."""
        with self._lock:
            if self._exposition_om is None:
                if self._om_batch is not None:
                    self._exposition_om = self._columnar_renderer().render(
                        self._om_batch, exemplars=self._exemplars,
                        openmetrics=True) + "# EOF\n"
                else:
                    self._exposition_om = render_exposition(
                        self._om_metrics, exemplars=self._exemplars,
                        openmetrics=True) + "# EOF\n"
            return self._exposition_om

    def _columnar_renderer(self):
        if self._renderer is None:
            from veneur_tpu_torch.core.egress import PrometheusColumnarRenderer
            self._renderer = PrometheusColumnarRenderer()
        return self._renderer

    def flush_batch(self, batch) -> None:
        if self.repeater_address:
            # the repeater re-emits per-metric statsd lines, which wants
            # the object list anyway — no columnar win to chase there
            self.flush(batch.materialize())
            return
        try:
            self.flush_columnar(batch)
        except Exception:
            logger.exception("prometheus columnar flush failed; "
                             "falling back to materialize()")
            self.flush(batch.materialize())

    def flush_columnar(self, batch) -> None:
        """Columnar fast path: render the plain 0.0.4 exposition straight
        from the FlushBatch arrays (byte-identical to render_exposition
        over materialize()), and park the batch so the lazy OpenMetrics
        variant renders columnar too on first negotiated scrape."""
        import time as _time

        t0 = _time.perf_counter()
        plain = self._columnar_renderer().render(batch)
        encode_s = _time.perf_counter() - t0
        with self._lock:
            self._exposition = plain
            self._om_metrics = []
            self._om_batch = batch
            self._exposition_om = None
        self.note_egress(encode_s, 0.0)

    def flush(self, metrics: List[InterMetric]) -> None:
        import time as _time

        t0 = _time.perf_counter()
        plain = render_exposition(metrics)
        encode_s = _time.perf_counter() - t0
        with self._lock:
            self._exposition = plain
            self._om_metrics = metrics
            self._om_batch = None
            self._exposition_om = None
        if not self.repeater_address or not metrics:
            self.note_egress(encode_s, 0.0, encoder="legacy")
            return
        t1 = _time.perf_counter()
        host, _, port = self.repeater_address.rpartition(":")
        lines = []
        for m in metrics:
            if m.type == MetricType.STATUS:
                continue
            kind = "c" if m.type == MetricType.COUNTER else "g"
            lines.append(render_metric_packet(
                m.name, m.value, kind, list(m.tags)))
        payload = b"\n".join(lines)
        try:
            if self.network == "tcp":
                with socket.create_connection((host, int(port)),
                                              timeout=5.0) as s:
                    s.sendall(payload + b"\n")
            else:
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                try:  # chunk to stay under typical datagram limits
                    for i in range(0, len(lines), 25):
                        s.sendto(b"\n".join(lines[i:i + 25]),
                                 (host, int(port)))
                finally:
                    s.close()
        except OSError as e:
            logger.error("prometheus repeater send failed: %s", e)
        self.note_egress(encode_s, _time.perf_counter() - t1,
                         encoder="legacy")

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()


@register_metric_sink("prometheus")
def _factory(sink_config, server_config):
    c = sink_config.config
    return PrometheusMetricSink(
        sink_config.name or "prometheus",
        repeater_address=c.get("repeater_address", ""),
        network=c.get("network_type", "udp"),
        expose_address=c.get("expose_address", ""))
