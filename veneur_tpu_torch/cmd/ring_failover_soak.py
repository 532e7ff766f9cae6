"""Ring-failover soak: kill and restore a global destination while
metrics stream through the proxy, and account for every metric (torch
port of scripts/ring_failover_soak.py).

What it exercises (the forward tier's HA machinery, proxy/):

- the proxy's active health probes eject the killed destination from
  the consistent-hash ring (its keys re-shard onto the survivors);
- routing failover keeps mergeable state flowing while the dead node's
  breaker is open;
- readmission restores the original assignment when the node returns.

The invariant is accounting exactness, not zero loss: the proxy tier
keeps no state (lossless carryover and spool live on the local tier),
so metrics enqueued at a dying destination in the detection window are
dropped, but every one of them must be counted (`received == sent` at
the proxy, `sent == received + counted drops` end to end), and once the
ejection lands the stream must flow loss-free through the survivors.

The soak runs no device code: the globals are in-process capture
servers (testing/forwardtest.py). Destination 0 binds a port below the
kernel's ephemeral range, so nothing else can be handed that port
between its stop and its restore on the same port. Run:

    python -m veneur_tpu_torch.cmd.ring_failover_soak \\
        --rounds 12 --per-round 200 --kill-round 3 --restore-round 7
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import sys
import time


# the bound of each wait for an ejection, a readmission and the settle:
# the margin a loaded host (the test suite under pytest -n 6) needs
WAIT_S = 30.0


def wait_until(pred, timeout=WAIT_S, step=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


def _low_port() -> int:
    """A free 127.0.0.1 TCP port below the kernel's ephemeral range: the
    kernel hands no such port to a bind to port 0 or to an outgoing
    connection, and the capture servers bind with SO_REUSEPORT, so a
    port 0 pick could be shared with a stranger after the stop."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.Random(os.getpid() ^ time.time_ns())
    for _ in range(500):
        port = rng.randrange(10000, low)
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
                s.bind(("127.0.0.1", port))
        except OSError:
            continue
        return port
    raise RuntimeError("no free port below the ephemeral range")


def run_soak(rounds: int = 12, per_round: int = 200, n_dest: int = 3,
             kill_round: int = 3, restore_round: int = 7,
             probe_interval: float = 0.1, verbose: bool = False) -> dict:
    """Stream `rounds` batches of counters through a proxy over `n_dest`
    in-process global stubs, killing destination 0 at `kill_round` and
    restoring it (same port) at `restore_round`. Returns the accounting
    report; raises AssertionError when an invariant breaks."""
    from veneur_tpu_torch.forward.client import ForwardClient
    from veneur_tpu_torch.forward.protos import metric_pb2
    from veneur_tpu_torch.proxy.proxy import create_static_proxy
    from veneur_tpu_torch.testing.forwardtest import ForwardTestServer

    t0 = time.perf_counter()
    received = [[] for _ in range(n_dest)]
    servers = []
    for i in range(n_dest):
        address = f"127.0.0.1:{_low_port()}" if i == 0 else "127.0.0.1:0"
        servers.append(ForwardTestServer(received[i].extend,
                                         address=address))
        servers[i].start()
    addresses = [s.address for s in servers]

    proxy = create_static_proxy(
        addresses,
        # fast detection for the soak; production defaults are 2s/3/2
        health_check_interval=probe_interval,
        health_check_timeout=0.25,
        health_unhealthy_after=2,
        health_healthy_after=2)
    proxy.start()
    client = ForwardClient(proxy.address, deadline=5.0)

    def mk(name, value):
        pbm = metric_pb2.Metric(name=name, type=metric_pb2.Counter,
                                scope=metric_pb2.Global)
        pbm.counter.value = value
        return pbm

    def ejected() -> bool:
        return addresses[0] in proxy.destinations.ejected_addresses()

    sent = 0
    events = []
    post_eject_sent = 0
    try:
        for rnd in range(rounds):
            if rnd == kill_round:
                servers[0].stop()
                events.append({"round": rnd, "event": "killed",
                               "address": addresses[0]})
                # wait for the prober to eject it so the re-shard window
                # is deterministic in the report: rounds from here on
                # must be loss-free (asserted below)
                t_kill = time.perf_counter()
                confirmed = wait_until(ejected)
                events.append({"round": rnd, "event": "ejected",
                               "confirmed": confirmed,
                               "seconds": round(
                                   time.perf_counter() - t_kill, 3)})
            if rnd == restore_round:
                servers[0] = ForwardTestServer(received[0].extend,
                                               address=addresses[0])
                servers[0].start()
                events.append({"round": rnd, "event": "restored"})
                t_back = time.perf_counter()
                if wait_until(lambda: not ejected()):
                    events.append({"round": rnd, "event": "readmitted",
                                   "seconds": round(
                                       time.perf_counter() - t_back, 3)})
            batch = [mk(f"soak.m.{rnd}.{i}", 1) for i in range(per_round)]
            client.send_protos(batch)
            sent += per_round
            if ejected() or rnd >= restore_round:
                post_eject_sent += per_round
            if verbose:
                print(f"round {rnd}: sent {per_round} "
                      f"(ejected={proxy.destinations.ejected_addresses()})",
                      file=sys.stderr)
        # settle: wait until the books balance (every sent metric either
        # received by a global or counted as a drop, live or retired, or
        # as no-destination at the proxy) and no retired destination
        # still holds a drained batch it has not booked. The retired fold
        # matters: a destination that self-closed on an open breaker was
        # replaced by discovery, and its counters would otherwise vanish
        # from the pool.
        dests = proxy.destinations
        dests.flush_wait(timeout=WAIT_S)

        def drops_total():
            with dests._lock:
                live = sum(d.dropped_total for d in dests._pool.values())
                return live + dests.retired_dropped_total

        def settled():
            with dests._lock:
                inflight = dests.retired_inflight
            return inflight == 0 and (
                sum(len(r) for r in received) + drops_total()
                + proxy.stats["no_destination_total"] >= sent)

        stats_settle = wait_until(settled)
    finally:
        client.close()
        proxy_stats = dict(proxy.stats)
        dests = proxy.destinations
        with dests._lock:
            dest_rows = {d.address: {"sent": d.sent_total,
                                     "dropped": d.dropped_total,
                                     "shed_open": d.shed_open_total}
                         for d in dests._pool.values()}
            dest_rows["<retired>"] = {
                "sent": dests.retired_sent_total,
                "dropped": dests.retired_dropped_total,
                "shed_open": dests.retired_shed_open_total,
                "inflight": dests.retired_inflight}
        health_rows = (proxy.ring_health.member_table()
                       if proxy.ring_health else [])
        proxy.stop()
        for s in servers:
            s.stop()

    got = sum(len(r) for r in received)
    dropped = sum(v["dropped"] for v in dest_rows.values())
    report = {
        "sent": sent,
        "received": got,
        "proxy": proxy_stats,
        "destinations": dest_rows,
        "member_table": health_rows,
        "events": events,
        "settled": stats_settle,
        # metrics lost in the kill -> ejection detection window (the
        # only legitimate loss at the stateless proxy tier)
        "detection_window_loss": sent - got,
    }
    accounted = got + dropped + proxy_stats["no_destination_total"]
    report["accounted"] = accounted
    report["loss_unaccounted"] = sent - accounted
    assert proxy_stats["received_total"] == sent, report
    assert report["loss_unaccounted"] == 0, report
    # loss-free after the ejection, per metric: every round sent at or
    # after the CONFIRMED ejection (the dead member is out of the ring
    # before that round's batch goes in) must land; drops are confined
    # to the kill -> ejection detection window
    report["post_eject_sent"] = post_eject_sent
    ejected_ok = any(e["event"] == "ejected" and e.get("confirmed")
                     for e in events)
    if ejected_ok and kill_round < rounds:
        received_names = {p.name for dest in received for p in dest}
        missing = [f"soak.m.{rnd}.{i}"
                   for rnd in range(kill_round, rounds)
                   for i in range(per_round)
                   if f"soak.m.{rnd}.{i}" not in received_names]
        report["post_eject_missing"] = len(missing)
        assert not missing, (missing[:10], report)
    report["seconds"] = round(time.perf_counter() - t0, 3)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--per-round", type=int, default=200)
    ap.add_argument("--destinations", type=int, default=3)
    ap.add_argument("--kill-round", type=int, default=3)
    ap.add_argument("--restore-round", type=int, default=7)
    ap.add_argument("--probe-interval", type=float, default=0.1)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    report = run_soak(rounds=args.rounds, per_round=args.per_round,
                      n_dest=args.destinations,
                      kill_round=args.kill_round,
                      restore_round=args.restore_round,
                      probe_interval=args.probe_interval,
                      verbose=args.verbose)
    json.dump(report, sys.stdout, indent=2, default=str)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
