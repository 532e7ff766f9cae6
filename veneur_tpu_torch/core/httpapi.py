"""Operator HTTP API (port of veneur_tpu/core/httpapi.py).

Endpoint parity with reference http.go:15-65: /healthcheck, /version,
/builddate, /config/json, /config/yaml (secrets redacted via
util.StringSecret), and optional /quitquitquit (config.http_quit). Runs
a stdlib ThreadingHTTPServer.

Pull-side self-telemetry (core/telemetry.py), the live query plane and
the alert engine are served at:
  GET /metrics       Prometheus text exposition of every self-metric
                     plus per-device CUDA memory gauges
  GET /debug/events  the event flight recorder (ring buffer, ?n=N)
  GET /debug/flush   the last N flush rounds (?waterfall=1: segment trees)
  GET /debug/memory  torch.cuda.memory_stats() per device
  GET /query         ?metric=&kind=&q=&tags=a:b,c:d&lo=&hi=
  GET /alerts        the alert rule table and its state machines

Every route of the JAX package answers. Those whose source the port
lacks answer what the JAX package answers for a server without one:
/debug/latency, /debug/reshard, /debug/ledger, /debug/traces,
/debug/cardinality and /debug/device 404 with the same body. The
profiling routes (/debug/pprof/profile, heap, allocs, goroutine, block,
mutex, threadcreate, /debug/profile/cpu and /debug/profile/device) need
core/profiling.py, which is not ported yet: they answer 501 naming it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

import torch
import yaml

import veneur_tpu_torch
from veneur_tpu_torch.core import latency as latency_mod
from veneur_tpu_torch.core import telemetry as telemetry_mod
from veneur_tpu_torch.core.latency import LatencyHist
from veneur_tpu_torch.core.query import (QueryError, QuerySpec,
                                         ReshardRetry, parse_tags)
from veneur_tpu_torch.util.secret import StringSecret

BUILD_DATE = "dev"

# routes timed individually; anything else buckets under path:other so
# scanning garbage paths can't mint unbounded label values
_TIMED_ROUTES = frozenset({
    "/healthcheck", "/healthcheck/tracing", "/healthcheck/ready",
    "/version", "/builddate", "/config/json", "/config/yaml", "/metrics",
    "/query", "/alerts", "/quitquitquit", "/import",
    "/debug/events", "/debug/flush", "/debug/latency", "/debug/ledger",
    "/debug/reshard", "/reshard",
    "/debug/traces", "/debug/cardinality", "/debug/device",
    "/debug/memory",
    "/debug/threads", "/debug/profile/cpu", "/debug/profile/device",
    "/debug/pprof", "/debug/pprof/", "/debug/pprof/profile",
    "/debug/pprof/heap", "/debug/pprof/allocs", "/debug/pprof/goroutine",
    "/debug/pprof/block", "/debug/pprof/mutex",
    "/debug/pprof/threadcreate", "/debug/pprof/cmdline",
    "/debug/pprof/symbol", "/debug/pprof/trace",
})

# the JAX package's answers for a server without the route's source
_NO_SOURCE = {
    "/debug/latency": b"no latency source\n",
    "/debug/reshard": b"no reshard controller\n",
    "/debug/ledger": b"no ledger source\n",
    "/debug/traces": b"no trace source\n",
    "/debug/cardinality": b"no cardinality source\n",
    "/debug/device": b"no device source\n",
}

# routes served by core/profiling.py in the JAX package
_PROFILING_ROUTES = frozenset({
    "/debug/profile/cpu", "/debug/profile/device", "/debug/pprof/profile",
    "/debug/pprof/heap", "/debug/pprof/allocs", "/debug/pprof/goroutine",
    "/debug/pprof/block", "/debug/pprof/mutex",
    "/debug/pprof/threadcreate",
})

_PPROF_INDEX = (
    b"veneur-tpu profiles:\n"
    b"  /debug/pprof/profile?seconds=N  pprof CPU profile\n"
    b"  /debug/pprof/heap               pprof heap profile\n"
    b"  /debug/pprof/goroutine          thread stacks (pprof)\n"
    b"  /debug/pprof/allocs             alias of heap\n"
    b"  /debug/pprof/block|mutex        empty (no analog)\n"
    b"  /debug/pprof/threadcreate       live-thread count\n"
    b"  /debug/pprof/cmdline|symbol     pprof text protocols\n"
    b"  /debug/profile/cpu?seconds=N    text CPU profile\n"
    b"  /debug/profile/device?seconds=N xprof device trace\n"
    b"  /debug/memory                   device memory JSON\n"
    b"  /debug/threads                  all-thread stacks\n"
    b"  /debug/events?n=N               event flight recorder\n"
    b"  /debug/flush?n=N                recent flush rounds\n"
    b"  /debug/flush?waterfall=1        per-family segment trees\n"
    b"  /debug/traces?trace_id=&interval=  cross-tier traces\n"
    b"  /debug/latency                  latency observatory\n"
    b"  /debug/ledger?intervals=N       flow-ledger conservation\n"
    b"  /debug/cardinality?top=N&name=  series cardinality\n"
    b"  /debug/device                   HBM ledger & shard balance\n"
    b"  /query?metric=&kind=&q=         live query plane\n"
    b"  /alerts                         alert rule states\n"
    b"  /metrics                        Prometheus exposition\n")


def config_to_dict(cfg: Any) -> Any:
    """Recursively serialize the Config dataclass tree, redacting secrets
    (reference util.StringSecret marshals as REDACTED)."""
    if isinstance(cfg, StringSecret):
        return str(cfg)
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: config_to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, dict):
        return {k: config_to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(v) for v in cfg]
    return cfg


def _json(obj) -> bytes:
    return json.dumps(obj, indent=2, default=str).encode()


class _Handler(BaseHTTPRequestHandler):
    server_ref = None  # class attr set per HTTPApi instance subclass

    def log_message(self, fmt, *args):  # silence default stderr access log
        pass

    def _send(self, status: int, body: bytes,
              content_type: str = "text/plain") -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        # which process answered (two instances may share a port under a
        # SO_REUSEPORT restart)
        self.send_header("X-Veneur-Pid", str(os.getpid()))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, status: int, error: str, **extra) -> None:
        self._send(status, json.dumps({"error": error, **extra}).encode()
                   + b"\n", "application/json")

    def do_GET(self) -> None:  # noqa: N802
        t0 = time.perf_counter()
        try:
            self._route_GET()
        finally:
            self.server_ref.observe_route(
                "GET", self.path, time.perf_counter() - t0)

    def _route_GET(self) -> None:
        api = self.server_ref
        path = self.path.split("?", 1)[0]
        if path in ("/healthcheck", "/healthcheck/tracing"):
            self._send(200, b"ok\n")
        elif path == "/healthcheck/ready":
            # not ready while the flush watchdog's budget is blown (the
            # server's ready_state); a standalone API is always ready
            ready, reason = True, ""
            if api.server is not None:
                ready, reason = api.server.ready_state()
            if ready:
                self._send(200, b"ready\n")
            else:
                self._send(503, json.dumps(
                    {"ready": False, "reason": reason}).encode() + b"\n",
                    "application/json")
        elif path == "/version":
            self._send(200, veneur_tpu_torch.__version__.encode())
        elif path == "/builddate":
            self._send(200, BUILD_DATE.encode())
        elif path == "/config/json":
            body = json.dumps(config_to_dict(api.config), indent=2).encode()
            self._send(200, body, "application/json")
        elif path == "/config/yaml":
            body = yaml.safe_dump(config_to_dict(api.config)).encode()
            self._send(200, body, "application/x-yaml")
        elif path == "/metrics":
            text = api.telemetry.registry.render_prometheus()
            # content negotiation as in the JAX package; the port renders
            # no exemplars, so the OpenMetrics body is the same text
            accept = self.headers.get("Accept") or ""
            if ("openmetrics" in accept
                    or _query_str(self.path, "exemplars").lower()
                    in ("1", "true", "yes")):
                self._send(200, (text + "# EOF\n").encode(),
                           "application/openmetrics-text; version=1.0.0; "
                           "charset=utf-8")
            else:
                self._send(200, text.encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/debug/events":
            limit = int(_query_float(self.path, "n", 0.0, max_value=1e6))
            self._send(200, api.telemetry.events_json(
                limit, kind=_query_str(self.path, "kind"),
                trace_id=_query_str(self.path, "trace_id")),
                "application/json")
        elif path == "/debug/flush":
            limit = int(_query_float(self.path, "n", 0.0, max_value=1e6))
            if _query_str(self.path, "waterfall").lower() not in (
                    "", "0", "false", "no"):
                self._send(200, _json({
                    "rounds": latency_mod.waterfall_rounds(
                        api.telemetry.flushes.snapshot(limit))}),
                    "application/json")
                return
            self._send(200, api.telemetry.flushes_json(limit),
                       "application/json")
        elif path in _NO_SOURCE:
            self._send(404, _NO_SOURCE[path])
        elif path == "/query":
            self._query()
        elif path == "/alerts":
            engine = getattr(api.server, "alerts", None)
            if engine is None:
                self._send(404, b"no alert engine\n")
                return
            self._send(200, _json(engine.report()), "application/json")
        elif path == "/debug/memory":
            self._send(200, _device_memory_report(), "application/json")
        elif path in _PROFILING_ROUTES:
            self._send(501, f"{path} needs core/profiling.py, which "
                            f"veneur_tpu_torch does not port yet\n".encode())
        elif path == "/debug/pprof/cmdline":
            # NUL-separated argv, the Go pprof cmdline contract
            self._send(200, b"\x00".join(
                a.encode("utf-8", "surrogateescape")
                for a in sys.argv), "text/plain")
        elif path == "/debug/pprof/symbol":
            self._send(200, b"num_symbols: 0\n", "text/plain")
        elif path == "/debug/pprof/trace":
            self._send(501, b"execution trace is a Go-runtime feature "
                            b"with no CPython analog; use "
                            b"/debug/pprof/profile or "
                            b"/debug/profile/device\n")
        elif path in ("/debug/pprof/", "/debug/pprof"):
            self._send(200, _PPROF_INDEX)
        elif path == "/debug/threads":
            names = {t.ident: t.name for t in threading.enumerate()}
            parts = []
            for ident, frame in sys._current_frames().items():
                parts.append(f"Thread {names.get(ident, '?')} ({ident}):\n")
                parts.extend(traceback.format_stack(frame))
                parts.append("\n")
            self._send(200, "".join(parts).encode())
        else:
            self._send(404, b"not found\n")

    def _query(self) -> None:
        """The live query plane (core/query.py) against a consistent
        read-only capture of the live generation."""
        plane = getattr(self.server_ref.server, "query_plane", None)
        if plane is None:
            self._send(404, b"no query source\n")
            return
        try:
            spec = QuerySpec.build(
                metric=_query_str(self.path, "metric"),
                kind=_query_str(self.path, "kind", "value"),
                q=_query_str(self.path, "q") or None,
                tags=parse_tags(_query_str(self.path, "tags")),
                lo=_query_str(self.path, "lo") or None,
                hi=_query_str(self.path, "hi") or None)
        except (QueryError, ValueError) as e:
            self._send_error_json(400, str(e))
            return
        try:
            result = plane.query(spec)
        except ReshardRetry as e:
            self._send_error_json(503, str(e), retry=True)
            return
        except QueryError as e:
            self._send_error_json(400, str(e))
            return
        except Exception as e:  # a device fault: best-effort, no crash
            self._send_error_json(500, str(e))
            return
        self._send(200, _json(result), "application/json")

    def do_POST(self) -> None:  # noqa: N802
        t0 = time.perf_counter()
        try:
            self._route_POST()
        finally:
            self.server_ref.observe_route(
                "POST", self.path, time.perf_counter() - t0)

    def _route_POST(self) -> None:
        api = self.server_ref
        path = self.path.split("?", 1)[0]
        if path == "/quitquitquit" and api.http_quit:
            self._send(200, b"bye\n")
            threading.Thread(target=api.quit, daemon=True).start()
        elif path == "/reshard":
            self._send(404, b"no reshard controller\n")
        else:
            self._send(404, b"not found\n")


def _query_str(path: str, key: str, default: str = "") -> str:
    vals = parse_qs(urlparse(path).query).get(key)
    return vals[0] if vals else default


def _query_float(path: str, key: str, default: float,
                 max_value: float = 60.0) -> float:
    """Bounded query-param parse (a bad or huge value is clamped)."""
    try:
        vals = parse_qs(urlparse(path).query).get(key)
        val = float(vals[0]) if vals else default
    except (TypeError, ValueError):
        return default
    return min(max(val, 0.0), max_value)


def _device_memory_report() -> bytes:
    """Per-device memory stats (the JAX package lists
    jax.Device.memory_stats()): torch.cuda.memory_stats() for each
    visible CUDA device, none without CUDA."""
    stats = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats.append({"device": f"cuda:{i}",
                          "memory_stats": torch.cuda.memory_stats(i)})
    return _json(stats)


class HTTPApi:
    """Serves the ops endpoints for a running server (or standalone, with
    a private registry)."""

    def __init__(self, config, server=None, address: str = "127.0.0.1:0",
                 http_quit: bool = False, on_quit=None):
        self.config = config
        self.server = server
        self.http_quit = http_quit
        self.on_quit = on_quit
        # per-route latency: every request lands in a per-(method, path)
        # llhist, exported as http.route.* rows
        self._route_hists: Dict[str, LatencyHist] = {}
        self._route_lock = threading.Lock()
        # /metrics & the flight recorder serve the owning server's
        # telemetry; a standalone API gets a private registry
        telemetry = getattr(server, "telemetry", None)
        if telemetry is None:
            telemetry = telemetry_mod.Telemetry()
            telemetry.registry.add_collector(
                telemetry_mod.device_memory_rows)
        self.telemetry = telemetry
        self.telemetry.registry.add_collector(self.route_telemetry_rows)
        host, _, port = address.rpartition(":")
        handler = type("BoundHandler", (_Handler,), {"server_ref": self})

        class _ReusableHTTPServer(ThreadingHTTPServer):
            def server_bind(self):
                if hasattr(socket, "SO_REUSEPORT"):
                    try:
                        self.socket.setsockopt(
                            socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
                    except OSError:
                        pass
                super().server_bind()

        self._httpd = _ReusableHTTPServer((host or "127.0.0.1", int(port)),
                                          handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self._httpd.server_address

    def observe_route(self, method: str, raw_path: str,
                      elapsed_s: float) -> None:
        path = raw_path.split("?", 1)[0]
        if path not in _TIMED_ROUTES:
            path = "other"
        key = f"{method} {path}"
        with self._route_lock:
            hist = self._route_hists.get(key)
            if hist is None:
                hist = self._route_hists[key] = LatencyHist("http.route")
        hist.observe(elapsed_s)

    def route_telemetry_rows(self):
        """http.route.{p50,p99} gauges + .count counter per route."""
        with self._route_lock:
            items = sorted(self._route_hists.items())
        rows = []
        for key, hist in items:
            method, _, path = key.partition(" ")
            tags = [f"method:{method}", f"path:{path}"]
            snap = hist.snapshot()
            for label in ("p50", "p99"):
                rows.append((f"http.route.{label}", "gauge",
                             snap[label], tags))
            rows.append(("http.route.count", "counter",
                         float(snap["count"]), tags))
        return rows

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-api", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def quit(self) -> None:
        if self.on_quit is not None:
            self.on_quit()
        else:
            self.stop()
