"""veneur-proxy CLI: the standalone consistent-hash forward router (port
of veneur_tpu/cmd/veneur_proxy.py).

Wires a discoverer (a static destination list, Consul or Kubernetes),
starts the gRPC proxy with its discovery-refresh loop and ring health
probes, optionally the statsd self-metrics and the HTTP API
(/healthcheck, /healthcheck/ready, /metrics, /debug/ledger,
/debug/events, /debug/cardinality, /debug/traces, /query), and blocks
until SIGINT or SIGTERM. The process imports no torch: the proxy holds no device state.

    python -m veneur_tpu_torch.cmd.veneur_proxy -f proxy.yaml
    python -m veneur_tpu_torch.cmd.veneur_proxy -destinations h1:8128,h2:8128

Both config shapes of the JAX CLI are read: the v2 shape
(`forward_addresses`, `discovery_interval`, `forward_service`,
`grpc_tls_address`, `ignore_tags`, `statsd`) and the legacy one
(`forward_address` as a comma-separated list,
`consul_refresh_interval`, `consul_forward_service_name`). Where the JAX
CLI ignores a key it does not read, this one raises with the key's
name. SIGUSR2 hands off to a replacement spawned from the same command
line (core/restart.py): the gRPC server and the HTTP API bind with
SO_REUSEPORT, and the replacement reports ready on `/healthcheck/ready`
when the HTTP API is configured, else through the ready file.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

import yaml

from veneur_tpu_torch.config import parse_duration
from veneur_tpu_torch.util.secret import StringSecret

# every key build_from_config reads
KEYS = frozenset({
    "forward_addresses", "forward_address", "discovery_interval",
    "consul_refresh_interval", "grpc_address", "grpc_tls_address",
    "forward_service", "consul_forward_service_name", "ignore_tags",
    "consul_address", "consul_token", "forward_service_discovery",
    "kubernetes_label_selector", "tls_certificate", "tls_key",
    "tls_authority_certificate", "forward_tls_certificate",
    "forward_tls_key", "forward_tls_authority_certificate",
    "shutdown_timeout", "send_buffer_size",
    "circuit_breaker_failure_threshold", "health_check_interval",
    "health_check_timeout", "health_unhealthy_after",
    "health_healthy_after", "health_probe", "health_http_url_template",
    "hedge_after", "failover_walk", "shard_groups", "ledger_enabled",
    "ledger_strict", "ledger_history", "statsd",
    "runtime_metrics_interval", "http_address",
    "trace_self_sample_rate", "trace_store_traces", "trace_store_spans",
    "latency_observatory",
})
_SECRET_KEYS = ("tls_key", "forward_tls_key")


def check_keys(raw: dict) -> dict:
    """Raise on a key the port's proxy does not implement; returns the
    config with its private keys as StringSecrets (redacted in
    /config/json)."""
    for key in raw:
        if key not in KEYS:
            raise ValueError(f"proxy config key {key!r} is not supported "
                             f"by veneur_tpu_torch")
    for key in (raw.get("statsd") or {}):
        if key != "address":
            raise ValueError(f"proxy config key 'statsd.{key}' is not "
                             f"supported by veneur_tpu_torch")
    out = dict(raw)
    for key in _SECRET_KEYS:
        if key in out:
            out[key] = StringSecret(str(out[key] or ""))
    return out


def _reveal(value) -> str:
    return value.reveal() if isinstance(value, StringSecret) else value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="veneur-proxy")
    ap.add_argument("-f", dest="config", default=None,
                    help="YAML config file")
    ap.add_argument("-destinations", default="",
                    help="comma-separated static global veneur addresses")
    ap.add_argument("-listen", default="0.0.0.0:8128",
                    help="gRPC listen address")
    ap.add_argument("-http", default="",
                    help="healthcheck HTTP address (host:port)")
    ap.add_argument("-discovery-interval", default="10s")
    ap.add_argument("-forward-service", default="veneur-global")
    ap.add_argument("-tls-cert", default="",
                    help="server TLS certificate (PEM or path)")
    ap.add_argument("-tls-key", default="",
                    help="server TLS private key (PEM or path)")
    ap.add_argument("-tls-ca", default="",
                    help="CA bundle; presence requires client certs (mTLS)")
    ap.add_argument("-dest-tls-ca", default="",
                    help="CA bundle for verifying destination servers")
    ap.add_argument("-dest-tls-cert", default="",
                    help="client certificate for dialing destinations")
    ap.add_argument("-dest-tls-key", default="",
                    help="client key for dialing destinations")
    ap.add_argument("-debug", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    log = logging.getLogger("veneur-proxy")

    raw = {}
    if args.config:
        with open(args.config) as f:
            raw = yaml.safe_load(f) or {}

    proxy, stats_loop, http_api = build_from_config(raw, args, log)

    # every listener is bound: report readiness to a parent mid-handoff
    from veneur_tpu_torch.core import restart
    restart.mark_ready()

    stop = threading.Event()

    def handle_signal(signum, frame):
        log.info("received signal %d, shutting down", signum)
        stop.set()

    signal.signal(signal.SIGINT, handle_signal)
    signal.signal(signal.SIGTERM, handle_signal)
    # SIGUSR2 graceful restart: the gRPC server binds with SO_REUSEPORT by
    # default and the HTTP API sets it, so the replacement binds beside
    # this process; once it is ready, stopping the main loop stops the
    # proxy. With an HTTP address the parent polls /healthcheck/ready,
    # without one it waits for the ready file (mark_ready above).
    restart.install(stop.set, raw.get("http_address", args.http) or "")
    stop.wait()
    proxy.stop(grace=proxy.shutdown_grace)
    if stats_loop is not None:
        stats_loop.stop()
    if http_api is not None:
        http_api.stop()
    return 0


def build_from_config(raw: dict, args, log):
    """Config dict + parsed flags -> started (proxy, stats_loop,
    http_api). Split from main() so both config shapes are testable
    without signal handlers (which only install on the main thread)."""
    from veneur_tpu_torch.proxy.discovery import (
        ConsulDiscoverer, KubernetesDiscoverer, StaticDiscoverer)
    from veneur_tpu_torch.proxy.proxy import ProxyServer
    from veneur_tpu_torch.util.grpctls import GrpcTLS
    from veneur_tpu_torch.util.matcher import TagMatcher

    raw = check_keys(raw)
    if raw.get("forward_addresses"):
        destinations = [d for d in raw["forward_addresses"] if d]
    else:
        destinations = [d for d in (
            raw.get("forward_address", "").split(",")
            if raw.get("forward_address") else args.destinations.split(","))
            if d]
    interval = parse_duration(
        raw.get("discovery_interval")
        or raw.get("consul_refresh_interval", args.discovery_interval))
    listen = raw.get("grpc_address", args.listen)
    forward_service = (raw.get("forward_service")
                       or raw.get("consul_forward_service_name",
                                  args.forward_service))
    ignore_tags = [TagMatcher.from_config(t)
                   for t in raw.get("ignore_tags", []) or []]

    # consul when a consul service name / address is configured,
    # kubernetes when asked for, static destinations otherwise
    if raw.get("consul_address") or raw.get("consul_forward_service_name"):
        discoverer = ConsulDiscoverer(
            base_url=raw.get("consul_address", "http://127.0.0.1:8500"),
            token=raw.get("consul_token", ""))
        log.info("using Consul discovery for %s", forward_service)
    elif raw.get("forward_service_discovery") == "kubernetes":
        discoverer = KubernetesDiscoverer(
            label_selector=raw.get(
                "kubernetes_label_selector", "app=veneur-global"))
        log.info("using Kubernetes discovery")
    else:
        discoverer = StaticDiscoverer(destinations)
    # `or`: an empty-string YAML value must not silently override an
    # explicitly passed CLI flag (that would downgrade to plaintext)
    tls = GrpcTLS(certificate=raw.get("tls_certificate") or args.tls_cert,
                  key=_reveal(raw.get("tls_key")) or args.tls_key,
                  authority=(raw.get("tls_authority_certificate")
                             or args.tls_ca))
    dest_tls = GrpcTLS(
        certificate=(raw.get("forward_tls_certificate")
                     or args.dest_tls_cert),
        key=_reveal(raw.get("forward_tls_key")) or args.dest_tls_key,
        authority=(raw.get("forward_tls_authority_certificate")
                   or args.dest_tls_ca))
    # validated before any port binds so a bad value fails at startup,
    # not mid-shutdown after SIGTERM
    shutdown_grace = parse_duration(raw.get("shutdown_timeout", "1s"))
    proxy = ProxyServer(
        discoverer,
        forward_service=forward_service,
        listen_address=listen,
        discovery_interval=interval,
        ignore_tags=ignore_tags,
        send_buffer=int(raw.get("send_buffer_size") or 4096),
        tls=tls or None,
        tls_listen_address=raw.get("grpc_tls_address", ""),
        destination_tls=dest_tls or None,
        max_consecutive_failures=int(
            raw.get("circuit_breaker_failure_threshold") or 3),
        latency_observatory=bool(raw.get("latency_observatory", True)),
        health_check_interval=parse_duration(
            raw.get("health_check_interval", "2s")),
        health_check_timeout=parse_duration(
            raw.get("health_check_timeout", "1s")),
        health_unhealthy_after=int(raw.get("health_unhealthy_after") or 3),
        health_healthy_after=int(raw.get("health_healthy_after") or 2),
        health_probe=raw.get("health_probe", "tcp"),
        health_http_url_template=raw.get("health_http_url_template", ""),
        hedge_after=parse_duration(raw.get("hedge_after", 0)),
        failover_walk=int(raw.get("failover_walk", 2)),
        shard_groups=int(raw.get("shard_groups") or 0),
        ledger_enabled=bool(raw.get("ledger_enabled", True)),
        ledger_strict=bool(raw.get("ledger_strict", False)),
        ledger_history=int(raw.get("ledger_history", 32)),
        trace_self_sample_rate=float(
            raw.get("trace_self_sample_rate", 1.0)),
        trace_store_traces=int(raw.get("trace_store_traces", 128)),
        trace_store_spans=int(raw.get("trace_store_spans", 256)))
    proxy.shutdown_grace = shutdown_grace
    proxy.start()
    log.info("veneur-proxy listening on %s -> %s", proxy.address,
             destinations)

    # self-telemetry (reference cmd/veneur-proxy/main.go:64-90): the
    # routing, destination, ring and ledger rows at scrape time, and
    # the RPC aggregates with runtime gauges to the statsd address
    telemetry = proxy.telemetry
    telemetry.registry.add_collector(proxy.telemetry_rows)
    telemetry.registry.add_collector(proxy.rpc_stats.telemetry_rows)
    stats_loop = None
    statsd_cfg = raw.get("statsd") or {}
    if statsd_cfg.get("address"):
        from veneur_tpu_torch.core.diagnostics import DiagnosticsLoop
        from veneur_tpu_torch.util.scopedstatsd import ScopedClient
        stats_client = ScopedClient(address=statsd_cfg["address"],
                                    registry=telemetry.registry)
        stats_loop = DiagnosticsLoop(
            stats_client,
            interval=parse_duration(
                raw.get("runtime_metrics_interval", "10s")),
            include_device=False,
            extra=lambda: proxy.rpc_stats.emit(stats_client))
        stats_loop.start()

    http_api = None
    http_addr = raw.get("http_address", args.http)
    if http_addr:
        from veneur_tpu_torch.core.httpapi import HTTPApi
        from veneur_tpu_torch.core.query import ProxyQueryView
        query_view = ProxyQueryView(proxy)
        telemetry.registry.add_collector(query_view.telemetry_rows)
        http_api = HTTPApi(raw, address=http_addr, telemetry=telemetry,
                           ready=proxy.ready_state,
                           ledger=proxy.ledger.report,
                           query=query_view.query,
                           cardinality=proxy.cardinality_report,
                           traces=proxy.trace_plane.report,
                           latency=proxy.latency.report)
        http_api.start()
        log.info("veneur-proxy HTTP API on %s:%d", *http_api.address)

    return proxy, stats_loop, http_api


if __name__ == "__main__":
    sys.exit(main())
