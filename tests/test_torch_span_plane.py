"""The port's span pipeline on the CPU (veneur_tpu_torch/core/server.py,
core/networking.py, trace/__init__.py):

- the span sink isolation buffer (`_SpanSinkWorker`): chunks, whole-chunk
  overflow drops counted, an empty buffer taking one oversized chunk,
  held against the JAX package's worker on the same submissions;
- the deterministic drain (`Server.drain_spans`): it returns once the
  counts meet, and raises with them while a sink hangs;
- the fan-out: with four span workers every span reaches every span sink
  exactly once, and a full channel drops and counts;
- SSF end to end over UDP (native and numpy decoders), UNIX and TCP
  framed streams from the port's trace client, against the expected
  series; a frame over `trace_max_length_bytes` closes its stream;
- the trace client's backends (UDP, stream with reconnect, buffered,
  channel) and span ids from an explicit generator.

Every wait is bounded: counts against a deadline, never a quiet period.
"""

from __future__ import annotations

import os
import random
import socket
import tempfile
import threading
import time

import pytest

from veneur_tpu.core.server import _SpanSinkWorker as JSpanSinkWorker
from veneur_tpu_torch import protocol, ssf, trace
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.server import Server, _SpanSinkWorker
from veneur_tpu_torch.sinks import SpanSink
from veneur_tpu_torch.sinks.channel import ChannelMetricSink, ChannelSpanSink

SIZES = dict(counter_capacity=64, gauge_capacity=64, histo_capacity=64,
             set_capacity=32, batch_cap=256)


def _server(span_sinks=(), **extra):
    cfg = config_from_dict({"hostname": "test", "interval": "1h",
                            "tpu": dict(SIZES, **extra.pop("tpu", {})),
                            **extra})
    sink = ChannelMetricSink()
    return Server(cfg, device="cpu", extra_metric_sinks=[sink],
                  extra_span_sinks=list(span_sinks),
                  rng=random.Random(3)), sink


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _span(i, trace_id=0, **kw):
    span = ssf.SSFSpan(id=i, trace_id=trace_id or i, name="op",
                       service="svc", start_timestamp=10**18,
                       end_timestamp=10**18 + 1000, **kw)
    span.metrics.append(ssf.count("sp.count", 1, {"k": "v"}))
    span.metrics.append(ssf.timing("sp.time", 0.001 * (i % 10), 1e-3))
    return span


class _GatedSink(SpanSink):
    """Records chunks; blocks in ingest_many until its gate opens."""

    def __init__(self, name="gated"):
        self._name = name
        self.gate = threading.Event()
        self.chunks = []

    def name(self):
        return self._name

    def ingest(self, span):
        self.ingest_many([span])

    def ingest_many(self, spans):
        self.gate.wait(30)
        self.chunks.append(list(spans))


# -- the isolation buffer -----------------------------------------------------


@pytest.mark.parametrize("capacity", [16, 40])
def test_sink_worker_chunks_and_overflow_match_jax(capacity):
    results = []
    for make in (lambda s: _SpanSinkWorker(s, capacity, lambda: None),
                 lambda s: JSpanSinkWorker(s, capacity)):
        sink = _GatedSink()
        worker = make(sink)
        worker.start()
        try:
            # the first chunk is taken at once and blocks the thread; the
            # rest queue against the capacity
            worker.submit_many(list(range(10)))
            assert _wait_for(lambda: not worker._pending, 10)
            for base in (100, 200, 300, 400):
                worker.submit_many(list(range(base, base + 12)))
            worker.submit_many([])
            dropped_before_gate = worker.dropped
            sink.gate.set()
        finally:
            worker.stop(timeout=10)
        results.append((dropped_before_gate, worker.dropped,
                        worker.ingested, sink.chunks))
    assert results[0] == results[1]
    assert results[0][1] > 0


def test_empty_buffer_takes_one_oversized_chunk():
    sink = _GatedSink()
    sink.gate.set()
    worker = _SpanSinkWorker(sink, 16, lambda: None)
    worker.start()
    try:
        worker.submit_many(list(range(100)))  # over capacity, buffer empty
        assert _wait_for(lambda: worker.completed == 100, 10)
    finally:
        worker.stop(timeout=10)
    assert (worker.dropped, worker.ingested, worker.accepted) == (0, 100, 100)


# -- the drain and the fan-out ------------------------------------------------


def test_drain_waits_for_the_sinks_and_raises_while_one_hangs():
    gated = _GatedSink()
    server, _ = _server([gated], span_channel_capacity=1000,
                        num_span_workers=2)
    server.start()
    try:
        for i in range(1, 51):
            server.handle_ssf_span(_span(i))
        with pytest.raises(TimeoutError, match="gated"):
            server.drain_spans(timeout=0.3)
        gated.gate.set()
        server.drain_spans(timeout=20)
        assert sum(len(c) for c in gated.chunks) == 50
        server.flush()
        got = {m.name: m.value for m in server.metric_sinks[0].drain()}
        assert got["sp.count"] == 50.0
        assert got["sp.time.count"] == 50.0
    finally:
        gated.gate.set()
        server.shutdown()


def test_four_workers_deliver_every_span_once_to_every_sink():
    sinks = [ChannelSpanSink("a"), ChannelSpanSink("b")]
    server, msink = _server(sinks, span_channel_capacity=5000,
                            num_span_workers=4,
                            span_sink_queue_capacity=10000)
    server.start()
    try:
        for i in range(1, 2001):
            server.handle_ssf_span(_span(i))
        server.drain_spans(timeout=30)
        server.flush()
        for sink in sinks:
            ids = sorted(s.id for s in sink.queue.get(timeout=10))
            assert ids == list(range(1, 2001))
        got = {m.name: m.value for m in msink.drain()}
        assert got["sp.count"] == 2000.0
        stats = server.stats_snapshot()
        assert stats["spans_dropped"] == 0
        assert stats["span_sink_dropped#sink:a"] == 0
        assert stats["span_sink_ingested#sink:b"] == 2000
        assert stats["spans_extracted"] == 2000
        timings = server.last_flush_timings
        assert timings["span_sink:a"]["status"] == "ok"
    finally:
        server.shutdown()


def test_a_full_channel_drops_and_counts():
    server, _ = _server(span_channel_capacity=5)
    # not started: nothing takes spans off the channel
    for i in range(1, 9):
        server.handle_ssf_span(_span(i))
    stats = server.stats_snapshot()
    assert (stats["spans_dropped"], stats["ssf_packets_received"]) == (3, 8)
    server.start()
    server.drain_spans(timeout=20)
    server.shutdown()


# -- SSF over sockets ---------------------------------------------------------


@pytest.mark.parametrize("disable_native", [False, True],
                         ids=["native", "numpy"])
def test_ssf_udp_end_to_end(disable_native):
    chan = ChannelSpanSink()
    server, msink = _server(
        [chan], ssf_listen_addresses=["udp://127.0.0.1:0"],
        span_channel_capacity=1000,
        tpu={"disable_native_parser": disable_native})
    server.start()
    try:
        addr = server.ssf_addresses[0]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            for i in range(1, 41):
                tx.sendto(_span(i).SerializeToString(), addr)
            tx.sendto(b"\xff\xfe not a span", addr)
        assert _wait_for(
            lambda: server.stats_snapshot()["ssf_packets_received"] == 41)
        server.drain_spans(timeout=20)
        server.flush()
        got = {m.name: m.value for m in msink.drain()}
        assert got["sp.count"] == 40.0 and got["sp.time.count"] == 40.0
        assert sorted(s.id for s in chan.queue.get(timeout=10)) == \
            list(range(1, 41))
        assert server.stats_snapshot()["ssf_parse_errors"] == 1
    finally:
        server.shutdown()


@pytest.mark.parametrize("scheme", ["unix", "tcp"])
def test_framed_streams_end_to_end(scheme):
    with tempfile.TemporaryDirectory() as tmp:
        address = (f"unix://{tmp}/ssf.sock" if scheme == "unix"
                   else "tcp://127.0.0.1:0")
        chan = ChannelSpanSink()
        server, msink = _server([chan], ssf_listen_addresses=[address],
                                span_channel_capacity=1000)
        server.start()
        try:
            target = server.ssf_addresses[0]
            backends = [trace.StreamBackend(target, unix=scheme == "unix")
                        for _ in range(3)]
            n = 0
            for k, backend in enumerate(backends):
                for i in range(20):
                    n += 1
                    backend.send(_span(1000 * (k + 1) + i))
            for backend in backends:
                backend.close()
            assert _wait_for(lambda: server.stats_snapshot()[
                "ssf_packets_received"] == n)
            server.drain_spans(timeout=20)
            server.flush()
            got = {m.name: m.value for m in msink.drain()}
            assert got["sp.count"] == float(n)
            assert len(chan.queue.get(timeout=10)) == n
        finally:
            server.shutdown()


def test_undecodable_frame_is_skipped_and_an_oversized_one_closes():
    server, msink = _server(ssf_listen_addresses=["tcp://127.0.0.1:0"],
                            trace_max_length_bytes=256,
                            span_channel_capacity=100)
    server.start()
    try:
        with socket.create_connection(server.ssf_addresses[0],
                                      timeout=10) as conn:
            conn.sendall(protocol.frame_ssf(_span(1)))
            body = b"\xff\xff\xff"
            conn.sendall(b"\x00" + len(body).to_bytes(4, "big") + body)
            conn.sendall(protocol.frame_ssf(_span(2)))
            big = _span(3)
            big.tags["pad"] = "x" * 400
            conn.sendall(protocol.frame_ssf(big))
            # the server closes the stream at the oversized header
            conn.settimeout(10)
            assert conn.recv(1) == b""
        assert _wait_for(lambda: server.stats_snapshot()[
            "ssf_packets_received"] == 3)
        server.drain_spans(timeout=20)
        server.flush()
        got = {m.name: m.value for m in msink.drain()}
        assert got["sp.count"] == 2.0
        assert server.stats_snapshot()["ssf_parse_errors"] == 1
    finally:
        server.shutdown()


def test_unknown_ssf_scheme_raises_with_its_name():
    server, _ = _server(ssf_listen_addresses=["sctp://127.0.0.1:0"])
    with pytest.raises(ValueError, match="sctp"):
        server.start()
    server.shutdown()


# -- the trace client ---------------------------------------------------------


def test_udp_backend_and_client_ids_from_the_generator():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(10)
        client = trace.Client(trace.UDPBackend(rx.getsockname()),
                              rng=random.Random(42))
        with client.start_span("root", "svc") as root:
            child = client.start_span("leaf", parent=root)
            child.add(ssf.count("c", 1))
            child.finish()
        client.flush(timeout=10)
        got = [protocol.parse_ssf(rx.recv(65536)) for _ in range(2)]
        client.close()
    leaf, parent = got
    assert (leaf.name, parent.name) == ("leaf", "root")
    assert leaf.trace_id == parent.id == parent.trace_id
    assert leaf.parent_id == parent.id and leaf.metrics[0].name == "c"
    ids = random.Random(42)
    assert parent.id == ids.getrandbits(62) | 1
    assert leaf.id == ids.getrandbits(62) | 1


def test_stream_backend_reconnects_after_the_peer_closes():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as lsock:
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(4)
        lsock.settimeout(10)
        backend = trace.StreamBackend(lsock.getsockname(), backoff=0.01)
        one, two = _span(1), _span(2)
        backend.send(one)
        first, _ = lsock.accept()
        first.settimeout(10)
        frame = protocol.frame_ssf(one)
        assert first.recv(len(frame), socket.MSG_WAITALL) == frame
        first.close()
        # the next sends find the dead connection and reconnect
        deadline = time.monotonic() + 10
        second = None
        while second is None and time.monotonic() < deadline:
            try:
                backend.send(two)
            except OSError:
                continue
            lsock.settimeout(0.2)
            try:
                second, _ = lsock.accept()
            except socket.timeout:
                pass
        assert second is not None
        second.settimeout(10)
        frame = protocol.frame_ssf(two)
        assert second.recv(len(frame), socket.MSG_WAITALL) == frame
        second.close()
        backend.close()


def test_buffered_and_channel_backends():
    got = []
    buffered = trace.BufferedBackend(trace.ChannelBackend(got.append),
                                     capacity=3)
    for i in range(1, 3):
        buffered.send(_span(i))
    assert got == []
    buffered.send(_span(3))  # a full buffer sends its burst
    assert [s.id for s in got] == [1, 2, 3]
    buffered.send(_span(4))
    buffered.flush()
    assert [s.id for s in got] == [1, 2, 3, 4]

    class _Failing:
        def send(self, span):
            raise OSError("down")

        def flush(self):
            pass

        def close(self):
            pass

    failing = trace.BufferedBackend(_Failing(), capacity=2)
    failing.send(_span(5))
    failing.send(_span(6))
    assert failing.dropped == 2
    # a server's span channel as the loopback backend
    server, msink = _server(span_channel_capacity=100)
    server.start()
    try:
        client = trace.Client(trace.ChannelBackend(server.handle_ssf_span),
                              rng=random.Random(1))
        for i in range(5):
            with client.start_span("op", "svc") as span:
                span.add(ssf.count("loop.c", 1))
        client.flush(timeout=10)
        client.close()
        server.drain_spans(timeout=20)
        server.flush()
        got = {m.name: m.value for m in msink.drain()}
        assert got["loop.c"] == 5.0
    finally:
        server.shutdown()


def test_unix_stream_listener_removes_a_stale_socket_file():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ssf.sock")
        open(path, "w").close()
        server, _ = _server(ssf_listen_addresses=[f"unix://{path}"])
        server.start()
        try:
            assert server.ssf_addresses == [path]
        finally:
            server.shutdown()


def test_span_plane_stress_keeps_every_span_and_count():
    """More span workers and producers than cores with a short switch
    interval: every span reaches the sink once and every count adds up
    (a lost update in the channel or buffer counts would hang the drain
    or break the totals)."""
    import sys
    workers = (os.cpu_count() or 4) + 4
    chan = ChannelSpanSink()
    server, msink = _server([chan], span_channel_capacity=50_000,
                            num_span_workers=workers,
                            span_sink_queue_capacity=100_000)
    server.start()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def produce(base):
            for i in range(base, base + 500):
                server.handle_ssf_span(_span(i))
        producers = [threading.Thread(target=produce, args=(1 + 500 * p,))
                     for p in range(8)]
        for t in producers:
            t.start()
        for t in producers:
            t.join(timeout=60)
            assert not t.is_alive()
        server.drain_spans(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    try:
        server.flush()
        assert sorted(s.id for s in chan.queue.get(timeout=10)) == \
            list(range(1, 4001))
        stats = server.stats_snapshot()
        assert (stats["ssf_packets_received"], stats["spans_extracted"],
                stats["spans_dropped"]) == (4000, 4000, 0)
        got = {m.name: m.value for m in msink.drain()}
        assert got["sp.count"] == 4000.0
    finally:
        server.shutdown()


def test_a_failed_native_ssf_batch_is_counted_and_raised_by_flush():
    server, _ = _server(ssf_listen_addresses=["udp://127.0.0.1:0"])

    def boom(*_args):
        raise ValueError("apply failed")
    server._ingester.ingest_ssf_buffer = boom
    server.start()
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            tx.sendto(_span(1).SerializeToString(), server.ssf_addresses[0])
        assert _wait_for(lambda: server.stats_snapshot()[
            "ingest_dispatch_errors"] == 1)
        with pytest.raises(RuntimeError, match="failed to apply"):
            server.flush()
    finally:
        server._dispatch_error = None
        server.shutdown()
