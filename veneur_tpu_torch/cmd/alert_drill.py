"""Alert drill: drive one rule through pending -> firing -> resolved
against a live server and verify the whole observable trail (torch port
of scripts/alert_drill.py).

The drill sends breaching samples at the server's statsd port until
`GET /alerts` shows the rule firing (through its `for:` hold-down),
then stops and waits for the breach to clear (the next flush resets the
live generation, so a quiet metric un-breaches by itself). It then
asserts the trail every operator surface should carry:

  * `/alerts` walked the states in order (pending seen, firing seen,
    then idle again with `transitions` incremented);
  * `/debug/events?kind=alert_transition` recorded each transition,
    every event stamped with an interval trace id;
  * `/metrics` exports the `alert.firing{rule:...}` page feed.

Self-contained by default: it boots a port Server on loopback, on the
card unless `-device cpu`, with a drill rule on the p99 of a timer (each
alert round's capture runs the t-digest flush kernel), and tears it
down after:

    python -m veneur_tpu_torch.cmd.alert_drill [-device cpu]

Or aim it at a running server whose config already carries the rule
(the drill only sends samples and reads HTTP):

    python -m veneur_tpu_torch.cmd.alert_drill \
        --http 127.0.0.1:8127 --statsd udp://127.0.0.1:8126 \
        --rule drill-p99 --metric drill.latency --breach 250 --wire ms

Exit codes: 0 drill passed, 1 a stage or assertion failed.
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import time
import urllib.request


def fetch(http: str, path: str):
    with urllib.request.urlopen(f"http://{http}{path}", timeout=10) as r:
        return json.loads(r.read())


def fetch_text(http: str, path: str) -> str:
    with urllib.request.urlopen(f"http://{http}{path}", timeout=10) as r:
        return r.read().decode()


def rule_row(http: str, rule_id: str):
    report = fetch(http, "/alerts")
    for row in report.get("rules", ()):
        if row["id"] == rule_id:
            return row
    return None


def wait_state(http: str, rule_id: str, states, timeout_s: float,
               seen: set, breach=None) -> str:
    """Poll /alerts until the rule reaches one of `states` (recording
    every state observed on the way in `seen`); optionally keep the
    breach generator running between polls."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if breach is not None:
            breach()
        row = rule_row(http, rule_id)
        if row is None:
            raise AssertionError(f"rule {rule_id!r} not in /alerts")
        seen.add(row["state"])
        if row["state"] in states:
            return row["state"]
        time.sleep(0.1)
    raise AssertionError(
        f"rule {rule_id!r} never reached {states} in {timeout_s:.0f}s "
        f"(saw {sorted(seen)})")


def run_drill(http: str, statsd: tuple, rule_id: str, metric: str,
              breach_value: float, wire: str, hold_margin_s: float,
              resolve_timeout_s: float) -> int:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    payload = ("%s:%g|%s" % (metric, breach_value, wire)).encode()

    def breach(n: int = 20):
        for _ in range(n):
            sock.sendto(payload, statsd)

    row = rule_row(http, rule_id)
    if row is None:
        print(f"FAIL: rule {rule_id!r} not present in /alerts")
        return 1
    transitions_before = row.get("transitions", 0)
    print(f"drill: rule {rule_id!r} starts {row['state']} "
          f"(op {row['op']} {row['threshold']}, for {row['for_s']}s)")

    seen: set = set()
    # phase 1: breach until the state machine walks to firing. A rule
    # with for: 0 jumps straight there; otherwise pending shows first.
    state = wait_state(http, rule_id, ("firing",),
                       row["for_s"] + hold_margin_s, seen, breach=breach)
    print(f"drill: reached {state} (path: {sorted(seen)})")
    if row["for_s"] > 0 and "pending" not in seen:
        print("FAIL: hold-down rule fired without a pending phase")
        return 1

    # phase 2: stop breaching; the next flush resets the live
    # generation, the metric stops resolving, and the rule un-fires
    state = wait_state(http, rule_id, ("idle",), resolve_timeout_s, seen)
    print(f"drill: resolved back to {state}")

    # trail assertion 1: /alerts transition counter moved
    row = rule_row(http, rule_id)
    if row.get("transitions", 0) < transitions_before + 2:
        print(f"FAIL: transitions counter {row.get('transitions')} "
              f"did not advance past {transitions_before}")
        return 1

    # trail assertion 2: the flight recorder holds the transition
    # events for this rule, each stamped with an interval trace id
    events = fetch(http, "/debug/events?kind=alert_transition&n=512")
    mine = [e for e in events.get("events", ())
            if e.get("rule") == rule_id]
    to_states = [e.get("to_state") for e in mine]
    missing = [s for s in ("firing", "resolved") if s not in to_states]
    if missing:
        print(f"FAIL: /debug/events missing transitions {missing} "
              f"(saw {to_states})")
        return 1
    unstamped = [e for e in mine if not e.get("trace_id")]
    if unstamped:
        print(f"FAIL: {len(unstamped)} transition event(s) missing an "
              f"interval trace id")
        return 1

    # trail assertion 3: the page feed exported through /metrics
    metrics_text = fetch_text(http, "/metrics")
    if "veneur_alert_firing" not in metrics_text:
        print("FAIL: /metrics has no alert.firing gauge")
        return 1

    print(f"PASS: {rule_id!r} walked pending -> firing -> resolved; "
          f"{len(mine)} transition events recorded, all trace-stamped")
    return 0


def self_contained(args) -> int:
    """Boot a loopback server on `args.device` with a drill rule, run the
    drill, tear down. The rule breaches on the drill timer's p99 with a
    short hold-down so the pending phase is observable."""
    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.core.server import Server

    cfg = config_from_dict({
        "interval": args.interval,
        "hostname": "alert-drill",
        "statsd_listen_addresses": ["udp://127.0.0.1:0"],
        "http_address": "127.0.0.1:0",
        "flush_on_shutdown": False,
        "alerts": {"interval": 0.2, "rules": [{
            "id": args.rule, "metric": args.metric, "kind": "quantile",
            "q": 0.99, "op": ">", "threshold": 100.0, "for": 0.6}]},
    })
    server = Server(cfg, device=args.device)
    server.start()
    try:
        http = "%s:%d" % server.http_api.address
        statsd = server.local_addr("udp")
        print(f"drill: self-contained server on {args.device} http={http} "
              f"statsd={statsd[0]}:{statsd[1]}")
        return run_drill(http, statsd, args.rule, args.metric,
                         args.breach, args.wire,
                         hold_margin_s=args.interval + 10.0,
                         resolve_timeout_s=args.interval * 2 + 10.0)
    finally:
        server.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="alert_drill", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--http", default="",
                    help="operator API host:port of a running server "
                         "(omit for a self-contained drill)")
    ap.add_argument("--statsd", default="udp://127.0.0.1:8126",
                    help="statsd ingest address of that server")
    ap.add_argument("--rule", default="drill-p99",
                    help="rule id to drive (must exist in the server's "
                         "alerts: block)")
    ap.add_argument("--metric", default="drill.latency",
                    help="metric the rule watches")
    ap.add_argument("--breach", type=float, default=250.0,
                    help="sample value that breaches the threshold")
    ap.add_argument("--wire", default="ms", choices=["ms", "h", "g", "c"],
                    help="wire type of the breach samples")
    ap.add_argument("--hold-margin", type=float, default=30.0,
                    dest="hold_margin",
                    help="extra seconds past for: to wait for firing")
    ap.add_argument("--resolve-timeout", type=float, default=60.0,
                    dest="resolve_timeout",
                    help="seconds to wait for the resolve after quiet")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="flush interval of the self-contained server")
    ap.add_argument("-device", default="cuda:0",
                    help="table device of the self-contained server "
                         "(default the card)")
    args = ap.parse_args(argv)

    if not args.http:
        return self_contained(args)
    host, _, port = args.statsd.rpartition("://")[-1].rpartition(":")
    return run_drill(args.http, (host or "127.0.0.1", int(port)),
                     args.rule, args.metric, args.breach, args.wire,
                     hold_margin_s=args.hold_margin,
                     resolve_timeout_s=args.resolve_timeout)


if __name__ == "__main__":
    sys.exit(main())
