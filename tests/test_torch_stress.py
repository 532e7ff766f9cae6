"""Concurrency stress on the port's ingest hot path (the cases of
tests/test_stress.py against veneur_tpu_torch's Server on the CPU).

N reader threads, a concurrent flusher and an import stream hammer ONE
column store for a few seconds; then sample conservation is asserted
exactly: every counter increment sent appears in exactly one flush, and
every thread stops within its join timeout. The shapes, reader counts
and durations are the JAX suite's. Beside them: the same datagrams in
order through a JAX Server and the port's give equal rows, and
`Server.local_addr` / `Server.handle_packet_buffer` keep the JAX
server's semantics.
"""

from __future__ import annotations

import os
import socket
import threading
import time

import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch import native
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.forward.client import ForwardClient
from veneur_tpu_torch.forward.protos import metric_pb2
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

# STRESS_DURATION_S=60 turns this into a long-soak hammer
DURATION_S = float(os.environ.get("STRESS_DURATION_S", 4.0))
READERS = 4
JOIN_S = 30.0


def make_server(tpu=None, **overrides):
    caps = {"counter_capacity": 1024, "gauge_capacity": 1024,
            "histo_capacity": 1024, "set_capacity": 256,
            "batch_cap": 1024, **(tpu or {})}
    cfg = config_from_dict({"interval": "3600s",  # flushed by hand below
                            "hostname": "stress", "tpu": caps,
                            **overrides})
    observer = ChannelMetricSink()
    return Server(cfg, device="cpu", extra_metric_sinks=[observer]), observer


def _run(threads, stop):
    """Start `threads`, let them run DURATION_S, set `stop` and join
    each (bounded)."""
    for t in threads:
        t.start()
    time.sleep(DURATION_S)
    stop.set()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), f"{t.name} failed to stop (deadlock?)"


def _flusher(server, observer, stop, keep, pause=0.02):
    def run():
        while not stop.is_set():
            server.flush()
            for metric in observer.drain():
                keep(metric)
            time.sleep(pause)
    return threading.Thread(target=run, name="flusher", daemon=True)


def _final_drain(server, observer, keep) -> None:
    """Apply whatever is still pending and flush once more."""
    server.store.apply_all_pending()
    server.flush()
    for metric in observer.drain():
        keep(metric)


class TestIngestFlushRaces:
    def test_sample_conservation_under_concurrent_flush(self):
        """Readers + a fast flusher racing on one store: the sum of the
        flushed counter values equals the samples ingested exactly."""
        server, observer = make_server()
        n_keys = 64
        datagrams = [b"\n".join(b"race.c%d:1|c" % k for k in range(n_keys))
                     for _ in range(8)]
        sent = [0] * READERS
        stop = threading.Event()
        flushed = []

        def keep(metric):
            if metric.name.startswith("race.c"):
                flushed.append(metric.value)

        def reader(slot):
            while not stop.is_set():
                server.handle_packet_batch(datagrams)
                sent[slot] += len(datagrams) * n_keys

        try:
            _run([threading.Thread(target=reader, args=(i,), daemon=True)
                  for i in range(READERS)]
                 + [_flusher(server, observer, stop, keep)], stop)
            _final_drain(server, observer, keep)
        finally:
            server.shutdown()
        assert sum(sent) > 0
        assert sum(flushed) == sum(sent), (
            f"lost/duplicated samples: flushed {sum(flushed)} of "
            f"{sum(sent)} sent")

    def test_histo_weight_conservation_under_concurrent_flush(self):
        """Timers under racing flushes: the flushed digest weight (the
        .count aggregate) equals the samples sent; exercises the staging
        grid's swap, compact and snapshot."""
        server, observer = make_server(aggregates=["count"],
                                       percentiles=[0.5])
        rng = np.random.default_rng(0)
        datagrams = [b"\n".join(b"race.t%d:%.2f|ms" % (k, v)
                                for k, v in enumerate(rng.normal(50, 5, 32)))
                     for _ in range(8)]
        per_batch = 8 * 32
        sent = [0] * READERS
        stop = threading.Event()
        counts = []

        def keep(metric):
            if metric.name.endswith(".count"):
                counts.append(metric.value)

        def reader(slot):
            while not stop.is_set():
                server.handle_packet_batch(datagrams)
                sent[slot] += per_batch

        try:
            _run([threading.Thread(target=reader, args=(i,), daemon=True)
                  for i in range(READERS)]
                 + [_flusher(server, observer, stop, keep)], stop)
            _final_drain(server, observer, keep)
        finally:
            server.shutdown()
        assert sum(sent) > 0
        # f32 weights of 1 stay exact far beyond these totals
        assert sum(counts) == sum(sent)

    def test_import_stream_races_readers_and_flusher(self):
        """The global-side triple: local readers + forwarded imports + a
        flusher on one store; counter conservation across both planes."""
        server, observer = make_server(grpc_address="127.0.0.1:0")
        server.start()
        try:
            client = ForwardClient(server.import_server.address,
                                   deadline=10.0)
            datagrams = [b"\n".join(b"race.m%d:1|c" % k for k in range(32))]
            local_sent = [0] * 2
            import_sent = [0]
            stop = threading.Event()
            flushed = []

            def keep(metric):
                if metric.name.startswith("race."):
                    flushed.append(metric.value)

            def reader(slot):
                while not stop.is_set():
                    server.handle_packet_batch(datagrams)
                    local_sent[slot] += 32

            def importer():
                while not stop.is_set():
                    protos = []
                    for k in range(16):
                        pbm = metric_pb2.Metric()
                        pbm.name = f"race.g{k}"
                        pbm.type = metric_pb2.Counter
                        pbm.scope = metric_pb2.Global
                        pbm.counter.value = 3
                        protos.append(pbm)
                    client.send_protos(protos)
                    import_sent[0] += 16 * 3
                    time.sleep(0.01)

            _run([threading.Thread(target=reader, args=(i,), daemon=True)
                  for i in range(2)]
                 + [threading.Thread(target=importer, daemon=True),
                    _flusher(server, observer, stop, keep)], stop)
            client.close()
            _final_drain(server, observer, keep)
            assert import_sent[0] > 0 and sum(local_sent) > 0
            assert sum(flushed) == sum(local_sent) + import_sent[0]
        finally:
            server.shutdown()

    def test_capacity_growth_under_load(self):
        """Interning new keys (capacity doublings and state re-layout)
        while other threads ingest and flush."""
        server, observer = make_server()
        stop = threading.Event()
        sent_known = [0]
        sent_new = [0]
        flushed = []

        def keep(metric):
            if metric.name.startswith("grow."):
                flushed.append(metric.value)

        def known_reader():
            dgram = b"\n".join(b"grow.k%d:1|c" % k for k in range(16))
            while not stop.is_set():
                server.handle_packet_batch([dgram])
                sent_known[0] += 16

        def new_key_reader():
            i = 0
            while not stop.is_set():
                batch = b"\n".join(
                    b"grow.n%d:1|c" % (i + j) for j in range(64))
                server.handle_packet_batch([batch])
                sent_new[0] += 64
                i += 64

        try:
            _run([threading.Thread(target=known_reader, daemon=True),
                  threading.Thread(target=new_key_reader, daemon=True),
                  _flusher(server, observer, stop, keep, pause=0.05)], stop)
            _final_drain(server, observer, keep)
            assert server.store.counters.capacity > 1024  # growth happened
        finally:
            server.shutdown()
        assert sum(flushed) == sent_known[0] + sent_new[0]


class TestSetPromotionRaces:
    def test_every_set_key_emitted_under_concurrent_flush(self):
        """Sets under racing flushes, hot enough to cross the host-tier
        -> device-bank promotion mid-interval (threshold 16, the card's
        automatic one, so the CPU run promotes too): every key ever sent
        appears in at least one flush."""
        server, observer = make_server(tpu={"set_promote_samples": 16})
        promotions = [0]
        promote = server.store.sets._promote_locked

        def counted(row):
            promotions[0] += 1
            return promote(row)
        server.store.sets._promote_locked = counted
        stop = threading.Event()
        sent_keys = set()
        lock = threading.Lock()
        emitted = set()

        def keep(metric):
            if metric.name.startswith("srace."):
                emitted.add(metric.name)

        def reader(slot):
            gen = 0
            while not stop.is_set():
                names = [b"srace.s%d_%d" % (slot, gen + g) for g in range(4)]
                # enough members per key to cross the threshold after a
                # few batches; datagram-sized buffers (a longer one is
                # one rejected line under metric_max_length)
                lines = [b"%s:m%d|s" % (nm, i)
                         for nm in names for i in range(64)]
                batch = [b"\n".join(lines[j:j + 40])
                         for j in range(0, len(lines), 40)]
                for _ in range(3):
                    server.handle_packet_batch(batch)
                with lock:
                    sent_keys.update(n.decode() for n in names)
                gen += 4

        try:
            _run([threading.Thread(target=reader, args=(i,), daemon=True)
                  for i in range(READERS)]
                 + [_flusher(server, observer, stop, keep)], stop)
            _final_drain(server, observer, keep)
        finally:
            server.shutdown()
        assert sent_keys and promotions[0] > 0
        missing = sent_keys - emitted
        assert not missing, f"{len(missing)} set keys never emitted"


class TestPumpConservation:
    def test_udp_pump_conserves_received_samples_under_flush(self):
        """The C++ pump: the native Blaster -> loopback -> pump readers ->
        chunk dispatch, under a flush hammer. Kernel-buffer UDP loss is
        legal; losing a sample after it was counted into
        store.processed is not: every counted counter increment appears
        in exactly one flush."""
        server, observer = make_server(
            statsd_listen_addresses=["udp://127.0.0.1:0"])
        # the server's own flush spans pass through metric extraction:
        # the 1 % uniqueness roll would add ssf.names_unique samples to
        # store.processed that the pump.stress.* filter cannot see
        server.metric_extraction.uniqueness_rate = 0.0
        server.start()
        flushed_total = [0.0]
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

        def count_flushes():
            for mm in observer.drain():
                if mm.name.startswith("pump.stress."):
                    flushed_total[0] += mm.value

        try:
            listener = server._listeners[0]
            assert listener.pump is not None
            # intern the keys so the measured window is all native
            server.handle_packet_batch(
                [b"\n".join(b"pump.stress.%d:1|c" % i for i in range(64))])
            server.flush()
            observer.drain()
            base = server.store.processed

            datagrams = [b"\n".join(b"pump.stress.%d:1|c" % ((j + k) % 64)
                                    for k in range(20))
                         for j in range(64)]
            blaster = native.Blaster(datagrams)
            sock.connect(server.local_addr("udp"))
            sent = [0]

            def send():
                # paced: the point is racing flushes, not overload
                sent[0] = blaster.run(sock.fileno(), burst=16,
                                      pace_pps=3000)

            sender = threading.Thread(target=send, daemon=True)
            sender.start()
            t0 = time.time()
            while time.time() - t0 < DURATION_S:
                server.flush()
                count_flushes()
                time.sleep(0.05)
            blaster.stop()
            sender.join(timeout=10)
            assert not sender.is_alive()
            blaster.close()
            # a deterministic drain: close the listener (joins the pump
            # readers and the dispatcher), so no chunk can land between
            # the final flush and the processed read
            listener.close()
            for t in listener._threads:
                assert not t.is_alive(), "pump drain stuck"
            server.flush()
            count_flushes()
            processed = server.store.processed - base
            assert sent[0] > 0 and processed > 0
            assert flushed_total[0] == processed, (
                f"flushed {flushed_total[0]} != processed {processed} "
                f"(sent {sent[0] * 20})")
        finally:
            sock.close()
            server.shutdown()


# -- parity with the JAX server ---------------------------------------------

def _corpus(seed: int, num_keys: int = 24):
    """Datagrams of mixed families (counters, gauges, timers, sets,
    `|l`), a malformed line and an event, in a seeded order."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(num_keys):
        lines.append(f"p.c{i}:{rng.integers(1, 50)}|c|@0.5|#t:{i % 3}")
        lines.append(f"p.g{i}:{rng.normal():.4f}|g")
        for _ in range(int(rng.integers(2, 20))):
            lines.append(f"p.t{i}:{rng.gamma(2, 10):.3f}|ms|#t:{i % 2}")
        for j in range(int(rng.integers(2, 14))):
            lines.append(f"p.s{i}:m{j}|s")
        for v in rng.lognormal(0, 5, 18):
            lines.append(f"p.l{i}:{v:.6g}|l" + ("|@0.5" if i % 2 else ""))
    lines += ["p.bad:abc|c", "_e{5,4}:title|text"]
    lines = [lines[i] for i in rng.permutation(len(lines))]
    return [b"\n".join(x.encode() for x in lines[j:j + 30])
            for j in range(0, len(lines), 30)]


def _jax_server(**listen):
    cfg = JConfig()
    cfg.hostname = "test"
    cfg.interval = 3600.0
    cfg.statsd_listen_addresses = listen.get("statsd", [])
    cfg.ssf_listen_addresses = listen.get("ssf", [])
    for key, value in {"counter_capacity": 64, "gauge_capacity": 64,
                       "histo_capacity": 64, "set_capacity": 32,
                       "llhist_capacity": 32, "batch_cap": 256}.items():
        setattr(cfg.tpu, key, value)
    sink = JChannel()
    return JServer(cfg.apply_defaults(), extra_metric_sinks=[sink]), sink


def _port_server(**listen):
    cfg = config_from_dict({
        "hostname": "test", "interval": "3600s",
        "statsd_listen_addresses": listen.get("statsd", []),
        "ssf_listen_addresses": listen.get("ssf", []),
        "tpu": {"counter_capacity": 64, "gauge_capacity": 64,
                "histo_capacity": 64, "set_capacity": 32,
                "llhist_capacity": 32, "batch_cap": 256}})
    sink = ChannelMetricSink()
    return Server(cfg, device="cpu", extra_metric_sinks=[sink]), sink


def _rows(server, sink):
    server.flush()
    return {(m.name, tuple(sorted(m.tags))): float(m.value)
            for m in sink.drain() if m.name.startswith("p.")}


def _assert_rows_agree(got: dict, want: dict) -> None:
    assert want and set(got) == set(want)
    for key, value in want.items():
        name = key[0]
        if "percentile" in name or name.endswith((".avg", ".median")):
            # K1's tolerance (tests/test_pallas.py)
            np.testing.assert_allclose(got[key], value, rtol=2e-5,
                                       atol=1e-4, err_msg=str(key))
        elif name.startswith("p.l") and name.endswith(".sum"):
            # the llhist .sum is a BLAS dot product over the registers
            np.testing.assert_allclose(got[key], value, rtol=1e-12,
                                       err_msg=str(key))
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("seed", [1, 2])
def test_same_datagrams_in_order_give_the_jax_servers_rows(seed):
    """One seeded corpus of datagrams, in order, through a JAX Server
    and the port's (each batch path), flushed once: equal rows."""
    dgrams = _corpus(seed)
    jserver, jsink = _jax_server()
    server, sink = _port_server()
    try:
        jserver.handle_packet_batch(dgrams)
        server.handle_packet_batch(dgrams)
        _assert_rows_agree(_rows(server, sink), _rows(jserver, jsink))
    finally:
        jserver.shutdown()
        server.shutdown()


def test_handle_packet_buffer_matches_the_jax_server():
    """handle_packet_buffer: the same buffers through both servers'
    slow path give the same rows; an over-long buffer is one parse error
    on both (the port books it as a rejected line, which is its ledger's
    ingress.parse_errors stage)."""
    dgrams = _corpus(3)
    jserver, jsink = _jax_server()
    server, sink = _port_server()
    try:
        for d in dgrams:
            jserver.handle_packet_buffer(d)
            server.handle_packet_buffer(d)
        jserver.store.apply_all_pending()
        server.store.apply_all_pending()
        _assert_rows_agree(_rows(server, sink), _rows(jserver, jsink))
        j0 = jserver.stats["parse_errors"]
        p0 = server.stats_snapshot()["lines_rejected"]
        long_buf = b"\n".join([b"p.long:1|c"] * 1000)
        assert len(long_buf) > server.config.metric_max_length
        assert len(long_buf) > jserver.config.metric_max_length
        jserver.handle_packet_buffer(long_buf)
        server.handle_packet_buffer(long_buf)
        assert jserver.stats["parse_errors"] - j0 == 1
        assert server.stats_snapshot()["lines_rejected"] - p0 == 1
        assert _rows(server, sink) == _rows(jserver, jsink) == {}
    finally:
        jserver.shutdown()
        server.shutdown()


def test_local_addr_answers_each_scheme_as_the_jax_server(tmp_path):
    """local_addr(scheme) over UDP, TCP and UNIX-datagram statsd
    listeners and an SSF UDP listener: each answers the bound address of
    its listener on both servers, an absent scheme None, and a datagram
    sent to local_addr("udp") is received."""
    listen = {k: {"statsd": ["udp://127.0.0.1:0", "tcp://127.0.0.1:0",
                             f"unixgram://{tmp_path}/{k}.sock"],
                  "ssf": ["udp://127.0.0.1:0"]} for k in ("jax", "port")}
    jserver, _jsink = _jax_server(**listen["jax"])
    server, _sink = _port_server(**listen["port"])
    jserver.start()
    server.start()
    try:
        for scheme in ("udp", "tcp", "ssf-udp"):
            for srv in (jserver, server):
                host, port = srv.local_addr(scheme)
                assert host == "127.0.0.1" and port > 0, (srv, scheme)
        assert jserver.local_addr() == jserver.local_addr("udp")
        assert server.local_addr() == server.local_addr("udp")
        assert server.local_addr() == server.listen_addresses[0]
        assert server.local_addr("ssf-udp") == server.ssf_addresses[0]
        assert jserver.local_addr("unixgram") == f"{tmp_path}/jax.sock"
        assert server.local_addr("unixgram") == f"{tmp_path}/port.sock"
        for scheme in ("ssf-tcp", "ssf-unix", "grpc"):
            assert jserver.local_addr(scheme) is None
            assert server.local_addr(scheme) is None
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.sendto(b"p.addr:1|c", server.local_addr("udp"))
        deadline = time.monotonic() + 10
        while server.stats_snapshot()["lines_received"] < 1:
            assert time.monotonic() < deadline, "datagram not received"
            time.sleep(0.01)
    finally:
        jserver.shutdown()
        server.shutdown()
