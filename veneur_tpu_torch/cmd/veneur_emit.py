"""veneur-emit: emit metrics/events/service-checks/spans to a veneur (a
copy of veneur_tpu/cmd/veneur_emit.py).

Parity with reference cmd/veneur-emit/main.go (969 LoC): emit one
metric via DogStatsD UDP/TCP (`-hostport`), SSF (`-ssf -mode ssf`), or
gRPC forward; `-command` runs a subprocess and emits its wall time as a
timer with a `status` tag, propagating the exit code (main.go:169,
createMetric:594). Event (`-e_*`) and service-check (`-sc_*`) packets
mirror the DogStatsD grammar the parser accepts (main.go:856/921).

Extra (this framework's benchmark driver): `-pps N -duration S` replays
the rendered packet at a target rate, reporting achieved throughput.

Run: python -m veneur_tpu_torch.cmd.veneur_emit \
        -hostport udp://127.0.0.1:8126 -name a.b.c -count 3 -tag foo:bar
"""

from __future__ import annotations

import argparse
import socket
import subprocess
import sys
import time

from typing import List, Tuple

from veneur_tpu_torch.protocol.render import (  # noqa: F401 (re-export)
    render_event_packet, render_metric_packet, render_service_check_packet,
)


def parse_hostport(hostport: str, default_scheme: str = "udp"
                   ) -> Tuple[str, str, int]:
    scheme = default_scheme
    rest = hostport
    if "://" in hostport:
        scheme, rest = hostport.split("://", 1)
    host, _, port = rest.rpartition(":")
    return scheme, host or "127.0.0.1", int(port)


def send_packet(hostport: str, packet: bytes) -> None:
    scheme, host, port = parse_hostport(hostport)
    if scheme == "tcp":
        with socket.create_connection((host, port), timeout=5.0) as s:
            s.sendall(packet + b"\n")
    else:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.sendto(packet, (host, port))
        finally:
            s.close()


def _parse_when(value: str) -> int:
    """Timestamp flag -> epoch nanoseconds. Accepts epoch seconds
    (possibly fractional) or an ISO-8601 date/time (the reference
    accepts free-form via dateparse; ISO is the documented subset)."""
    try:
        return int(float(value) * 1e9)
    except ValueError:
        from datetime import datetime
        return int(datetime.fromisoformat(value).timestamp() * 1e9)


def send_span(hostport: str, name: str, service: str, tags: List[str],
              duration_s: float, error: bool, metrics=(),
              trace_id: int = 0, parent_id: int = 0,
              start: str = "", end: str = "",
              indicator: bool = False) -> None:
    """Send one SSF span (UDP datagram, unframed)."""
    from veneur_tpu_torch.ssf.protos import ssf_pb2
    scheme, host, port = parse_hostport(hostport)
    now_ns = time.time_ns()
    span = ssf_pb2.SSFSpan()
    span.id = now_ns & 0x7FFFFFFF
    span.trace_id = trace_id or span.id
    if parent_id:
        span.parent_id = parent_id
    span.name = name
    span.service = service
    if end:
        span.end_timestamp = _parse_when(end)
    elif start:
        # start without end: the span covers the requested duration
        # from that start, not start..now
        span.end_timestamp = _parse_when(start) + int(duration_s * 1e9)
    else:
        span.end_timestamp = now_ns
    span.start_timestamp = (_parse_when(start) if start
                            else span.end_timestamp - int(duration_s * 1e9))
    span.error = error
    span.indicator = indicator
    for t in tags:
        k, _, v = t.partition(":")
        span.tags[k] = v
    for sample in metrics:
        span.metrics.append(sample)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.sendto(span.SerializeToString(), (host, port))
    finally:
        s.close()


def send_ssf_metric(hostport: str, name: str, value, mtype: str,
                    tags: List[str], rate: float = 1.0) -> None:
    """-ssf: ship the metric as an SSF sample attached to a metrics-only
    span (reference main.go ToSSF / sendSSF path) instead of DogStatsD."""
    from veneur_tpu_torch import ssf as ssf_helpers
    tag_map = dict(t.partition(":")[::2] for t in tags)
    if mtype == "c":
        sample = ssf_helpers.count(name, float(value), tags=tag_map)
    elif mtype == "g":
        sample = ssf_helpers.gauge(name, float(value), tags=tag_map)
    elif mtype == "ms":
        sample = ssf_helpers.timing(name, float(value) / 1000.0,
                                    1e-3, tags=tag_map)
    else:
        sample = ssf_helpers.set_sample(name, str(value), tags=tag_map)
    sample.sample_rate = rate
    send_span(hostport, "", "veneur-emit", [], 0.0, False,
              metrics=[sample])


def send_grpc(target: str, name: str, value: float, mtype: str,
              tags: List[str], authority: str = "") -> None:
    """Emit one global-scoped metric over the gRPC forward plane (mode
    grpc). `authority` mirrors the reference's -proxy flag (the HTTP/2
    :authority header, for emitting through an L7 proxy). The JAX CLI
    names enum values metric.proto does not define (GLOBAL_ONLY, GAUGE,
    COUNTER) and raises here; the port uses the proto's names."""
    from veneur_tpu_torch.forward.client import ForwardClient
    from veneur_tpu_torch.forward.protos import metric_pb2
    pbm = metric_pb2.Metric()
    pbm.name = name
    pbm.tags.extend(tags)
    pbm.scope = metric_pb2.Global
    if mtype == "gauge":
        pbm.type = metric_pb2.Gauge
        pbm.gauge.value = value
    else:
        pbm.type = metric_pb2.Counter
        pbm.counter.value = int(value)
    client = ForwardClient(target, authority=authority)
    try:
        client.send_protos([pbm])
    finally:
        client.close()


def replay(hostport: str, packet: bytes, pps: float,
           duration: float) -> Tuple[int, float]:
    """Blast `packet` at ~pps for `duration` seconds (load driver)."""
    scheme, host, port = parse_hostport(hostport)
    if scheme != "udp":
        raise ValueError(f"replay supports udp only, not {scheme!r}")
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sent = 0
    start = time.perf_counter()
    end = start + duration
    batch = max(1, int(pps // 100))  # pace in 10ms slices
    try:
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            target_sent = (now - start) * pps
            if sent > target_sent:
                time.sleep(min(0.01, (sent - target_sent) / pps))
                continue
            for _ in range(batch):
                s.sendto(packet, (host, port))
            sent += batch
    finally:
        s.close()
    elapsed = time.perf_counter() - start
    return sent, sent / elapsed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="veneur-emit")
    ap.add_argument("-hostport", default="udp://127.0.0.1:8126")
    ap.add_argument("-mode", choices=["metric", "event", "sc", "span"],
                    default="metric")
    ap.add_argument("-name", default="")
    ap.add_argument("-count", type=float, default=None)
    ap.add_argument("-gauge", type=float, default=None)
    ap.add_argument("-timing", default=None,
                    help="duration, e.g. 30ms")
    ap.add_argument("-set", dest="set_value", default=None)
    ap.add_argument("-rate", type=float, default=1.0)
    ap.add_argument("-tag", action="append", default=[])
    ap.add_argument("-debug", action="store_true")
    ap.add_argument("-ssf", action="store_true",
                    help="send the metric as an SSF sample instead of "
                         "DogStatsD (reference -ssf)")
    ap.add_argument("-grpc", action="store_true",
                    help="emit over the gRPC forward plane")
    ap.add_argument("-proxy", default="",
                    help="authority override for the gRPC channel "
                         "(reference -proxy)")
    ap.add_argument("-command", nargs=argparse.REMAINDER, default=None,
                    help="run a command; emit its wall time as a timer")
    # events (reference flag names; -e_aggregation_key kept as an alias
    # of -e_aggr_key)
    ap.add_argument("-e_title", default="")
    ap.add_argument("-e_text", default="")
    ap.add_argument("-e_time", default="")
    ap.add_argument("-e_aggr_key", "-e_aggregation_key",
                    dest="e_aggregation_key", default="")
    ap.add_argument("-e_priority", default="")
    ap.add_argument("-e_source_type", default="")
    ap.add_argument("-e_alert_type", default="")
    ap.add_argument("-e_hostname", default="")
    ap.add_argument("-e_event_tags", default="",
                    help="extra event tags, comma separated")
    # service checks
    ap.add_argument("-sc_name", default="")
    ap.add_argument("-sc_status", type=int, default=0)
    ap.add_argument("-sc_msg", default="")
    ap.add_argument("-sc_time", default="")
    ap.add_argument("-sc_hostname", default="")
    ap.add_argument("-sc_tags", default="",
                    help="extra service-check tags, comma separated")
    # span mode (-error is the reference name; -span_error kept)
    ap.add_argument("-span_service", default="veneur-emit")
    ap.add_argument("-error", "-span_error", dest="span_error",
                    action="store_true")
    ap.add_argument("-span_duration", type=float, default=0.0)
    ap.add_argument("-trace_id", type=int, default=0)
    ap.add_argument("-parent_span_id", type=int, default=0)
    ap.add_argument("-span_starttime", default="")
    ap.add_argument("-span_endtime", default="")
    ap.add_argument("-indicator", action="store_true")
    ap.add_argument("-span_tags", default="",
                    help="extra span tags, comma separated")
    # load driver
    ap.add_argument("-pps", type=float, default=0.0)
    ap.add_argument("-duration", type=float, default=10.0)
    args = ap.parse_args(argv)

    if args.debug:
        import logging
        logging.basicConfig(level=logging.DEBUG)

    if args.command is not None:
        start = time.perf_counter()
        proc = subprocess.run(args.command)
        elapsed_ms = (time.perf_counter() - start) * 1000
        status = "0" if proc.returncode == 0 else str(proc.returncode)
        packet = render_metric_packet(
            args.name or "veneur_emit.command", f"{elapsed_ms:.3f}", "ms",
            args.tag + [f"status:{status}"])
        send_packet(args.hostport, packet)
        return proc.returncode

    def _split(csv):
        return [t for t in csv.split(",") if t]

    def _epoch(value: str) -> str:
        """-e_time/-sc_time -> whole epoch seconds: the DogStatsD d:
        grammar is integer-only, so ISO/fractional input is normalized
        here (the same forms _parse_when takes for span times) instead
        of being sent raw for the server to reject."""
        return str(_parse_when(value) // 1_000_000_000) if value else ""

    if args.mode == "event":
        send_packet(args.hostport, render_event_packet(
            args.e_title, args.e_text, args.tag + _split(args.e_event_tags),
            args.e_aggregation_key, args.e_priority,
            args.e_source_type, args.e_alert_type, args.e_hostname,
            timestamp=_epoch(args.e_time)))
        return 0
    if args.mode == "sc":
        send_packet(args.hostport, render_service_check_packet(
            args.sc_name, args.sc_status, args.tag + _split(args.sc_tags),
            args.sc_msg, hostname=args.sc_hostname,
            timestamp=_epoch(args.sc_time)))
        return 0
    if args.mode == "span":
        send_span(args.hostport, args.name or "veneur_emit.span",
                  args.span_service, args.tag + _split(args.span_tags),
                  args.span_duration, args.span_error,
                  trace_id=args.trace_id, parent_id=args.parent_span_id,
                  start=args.span_starttime, end=args.span_endtime,
                  indicator=args.indicator)
        return 0

    if args.count is not None:
        value, mtype = args.count, "c"
    elif args.gauge is not None:
        value, mtype = args.gauge, "g"
    elif args.timing is not None:
        from veneur_tpu_torch.config import parse_duration
        value, mtype = parse_duration(args.timing) * 1000, "ms"
    elif args.set_value is not None:
        value, mtype = args.set_value, "s"
    else:
        print("need one of -count/-gauge/-timing/-set", file=sys.stderr)
        return 2

    if args.ssf:
        send_ssf_metric(args.hostport, args.name, value, mtype, args.tag,
                        args.rate)
        return 0
    if args.grpc:
        send_grpc(args.hostport,
                  args.name, float(value),
                  "gauge" if mtype == "g" else "counter", args.tag,
                  authority=args.proxy)
        return 0

    packet = render_metric_packet(args.name, value, mtype, args.tag,
                                  args.rate)
    if args.pps > 0:
        sent, rate = replay(args.hostport, packet, args.pps, args.duration)
        print(f"sent {sent} packets at {rate:.0f}/s")
        return 0
    send_packet(args.hostport, packet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
