"""veneur-prometheus: poll a Prometheus endpoint, emit DogStatsD (a port
of veneur_tpu/cmd/veneur_prometheus.py).

Every interval, scrape `-metrics-host`, convert the families (counters
to deltas, gauges as they are: the conversion of the openmetrics
source), and send DogStatsD packets to `-statsd-host` (or a UNIX
datagram `-socket`). With `-scrapes N` it exits after N scrapes (the
first only primes the counters); on exit it prints one JSON line with
its scrapes, failed scrapes and packets sent.

Run: python -m veneur_tpu_torch.cmd.veneur_prometheus \
        -metrics-host http://127.0.0.1:9090/metrics \
        -statsd-host 127.0.0.1:8126
"""

from __future__ import annotations

import argparse
import json
import logging
import socket
import sys

from veneur_tpu_torch.protocol.render import render_metric_packet
from veneur_tpu_torch.samplers import metrics as m
from veneur_tpu_torch.sources.openmetrics import OpenMetricsSource

log = logging.getLogger("veneur-prometheus")


class StatsdEmitter:
    """Ingest boundary that renders each metric back to DogStatsD.

    unix_socket routes packets over an AF_UNIX datagram socket instead
    of UDP (reference main.go:28 -socket, for proxy setups)."""

    def __init__(self, statsd_host: str, prefix: str = "",
                 unix_socket: str = ""):
        self.prefix = prefix
        if unix_socket:
            self.addr = unix_socket
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        else:
            host, _, port = statsd_host.rpartition(":")
            self.addr = (host or "127.0.0.1", int(port))
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.emitted = 0

    def ingest_metric(self, metric) -> None:
        kind = {m.COUNTER: "c", m.GAUGE: "g"}.get(metric.type, "g")
        # counter deltas stay float: truncating would permanently drop
        # fractional growth of slow cumulative counters
        packet = render_metric_packet(
            f"{self.prefix}{metric.name}", metric.value, kind,
            list(metric.tags))
        try:
            self.sock.sendto(packet, self.addr)
            self.emitted += 1
        except OSError as e:
            log.error("statsd send failed: %s", e)


def main(argv=None) -> int:
    # add_help=False: the reference uses -h for the metrics host
    # (main.go:15), so --help takes over the help slot
    ap = argparse.ArgumentParser(prog="veneur-prometheus", add_help=False)
    # exact-match option strings beat argparse's "-hVALUE" short-option
    # parse, so -help keeps printing usage like the Go binary's flag pkg
    ap.add_argument("--help", "-help", action="help")
    ap.add_argument("-h", "-metrics-host", dest="metrics_host",
                    default="http://localhost:9090/metrics",
                    help="full URL to query for Prometheus metrics")
    ap.add_argument("-s", "-statsd-host", dest="statsd_host",
                    default="127.0.0.1:8126")
    ap.add_argument("-i", "-interval", dest="interval", default="10s")
    ap.add_argument("-p", "-prefix", dest="prefix", default="",
                    help='prefix for emitted metrics, e.g. "myservice."')
    ap.add_argument("-ignored-labels", dest="ignored_labels", default="",
                    help="comma-separated label-name regexes to drop")
    ap.add_argument("-ignored-metrics", dest="ignored_metrics", default="",
                    help="comma-separated metric-name regexes to skip")
    ap.add_argument("-r", "-rename-labels", dest="renamed", default="",
                    help='label rename rules, "old=new,old2=new2"')
    ap.add_argument("-a", "-added-labels", dest="added", default="",
                    help='extra tags, "k=v,k2=v2" or "k:v,k2:v2"')
    ap.add_argument("-cert", default="",
                    help="client cert for mTLS scrape")
    ap.add_argument("-key", default="", help="client key for mTLS scrape")
    ap.add_argument("-cacert", default="",
                    help="CA cert validating the scraped server")
    ap.add_argument("-socket", default="",
                    help="unix datagram socket for statsd transport")
    ap.add_argument("-scrapes", type=int, default=0,
                    help="exit after this many scrapes (0: run until "
                         "interrupted)")
    ap.add_argument("-d", "-debug", dest="debug", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")

    ssl_context = None
    if args.cert or args.cacert:
        import ssl
        ssl_context = ssl.create_default_context(
            cafile=args.cacert or None)
        if args.cert:
            ssl_context.load_cert_chain(args.cert, args.key or None)

    from veneur_tpu_torch.config import parse_duration
    ignored_metrics = "|".join(
        p for p in args.ignored_metrics.split(",") if p) or None
    source = OpenMetricsSource(
        "veneur-prometheus",
        url=args.metrics_host,
        scrape_interval=parse_duration(args.interval),
        tags=[t.replace("=", ":", 1) for t in args.added.split(",") if t],
        denylist=ignored_metrics,
        ignored_labels=[p for p in args.ignored_labels.split(",") if p],
        rename_labels=dict(r.split("=", 1)
                           for r in args.renamed.split(",") if "=" in r),
        ssl_context=ssl_context)
    emitter = StatsdEmitter(args.statsd_host, args.prefix,
                            unix_socket=args.socket)

    try:
        source.start(emitter, max_scrapes=args.scrapes)  # Ctrl-C stops
    except KeyboardInterrupt:
        source.stop()
    print(json.dumps({"scrapes": source.scrapes,
                      "scrape_failures": source.scrape_failures,
                      "sent": emitter.emitted}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
