"""Trace client library: buffered SSF span reporting (a copy of
veneur_tpu/trace/__init__.py, beside the self-trace plane's pure helpers
in `store.py`).

Parity with the reference trace package (reference trace/client.go:56-230,
trace/trace.go:1-394): a `Client` buffers spans on a bounded queue and a
sender thread writes them to a pluggable backend — UDP (one unframed span
per datagram), UNIX/TCP stream (framed via protocol.write_ssf, with
reconnect), or a channel backend that loops spans straight into an
in-process server's span pipeline (reference server.go:518-524
NewChannelClient). `start_span` produces context-manager spans with
trace/parent lineage and attached samples. Span ids come from the
client's generator (or one the caller passes), not from a module-global
one.
"""

from __future__ import annotations

import logging
import queue
import random
import socket
import threading
import time
from typing import Dict, Optional

from veneur_tpu_torch import protocol, ssf

logger = logging.getLogger("veneur_tpu_torch.trace")

def _gen_id(rng: random.Random) -> int:
    # non-zero positive int63, like the reference's proto ids
    return rng.getrandbits(62) | 1


class Span:
    """An in-flight operation being timed; finish() reports it. Its id
    is drawn from `rng`, else from the client's generator (a span
    without a client needs `rng`)."""

    def __init__(self, client: Optional["Client"], name: str, service: str,
                 trace_id: int = 0, parent_id: int = 0,
                 tags: Optional[Dict[str, str]] = None,
                 indicator: bool = False,
                 rng: Optional[random.Random] = None):
        self.client = client
        self._rng = rng if rng is not None else client.rng
        self.proto = ssf.SSFSpan(
            id=_gen_id(self._rng),
            trace_id=trace_id or 0,
            parent_id=parent_id,
            name=name,
            service=service,
            indicator=indicator,
            start_timestamp=int(time.time() * 1e9),
        )
        if not self.proto.trace_id:
            self.proto.trace_id = self.proto.id
        if tags:
            for k, v in tags.items():
                self.proto.tags[k] = v
        self._finished = False

    @property
    def trace_id(self) -> int:
        return self.proto.trace_id

    @property
    def id(self) -> int:
        return self.proto.id

    def set_tag(self, key: str, value: str) -> None:
        self.proto.tags[key] = value

    def error(self, flag: bool = True) -> None:
        self.proto.error = flag

    def add(self, *samples) -> None:
        """Attach metric samples to be extracted on the server."""
        self.proto.metrics.extend(samples)

    def child(self, name: str, tags: Optional[Dict[str, str]] = None) -> "Span":
        return Span(self.client, name, self.proto.service,
                    trace_id=self.proto.trace_id, parent_id=self.proto.id,
                    tags=tags, rng=self._rng)

    def finish(self, end_time: Optional[float] = None) -> None:
        """Report the span; `end_time` (unix seconds) lets a caller
        reconstruct a measured segment post-hoc (the flush waterfall's
        per-family child spans) instead of stamping "now"."""
        if self._finished:
            return
        self._finished = True
        self.proto.end_timestamp = int(
            (time.time() if end_time is None else end_time) * 1e9)
        if self.client is not None:
            self.client.record(self.proto)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.error()
        self.finish()


# -- backends ------------------------------------------------------------

class ChannelBackend:
    """Deliver spans straight into an in-process server's span channel
    (the internal loopback, reference server.go:518-524)."""

    def __init__(self, ingest_span):
        self._ingest = ingest_span

    def send(self, span: ssf.SSFSpan) -> None:
        self._ingest(span)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class UDPBackend:
    """One unframed protobuf span per datagram."""

    def __init__(self, address):
        self.address = address
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, span: ssf.SSFSpan) -> None:
        self._sock.sendto(span.SerializeToString(), self.address)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._sock.close()


class StreamBackend:
    """Framed spans over a UNIX or TCP stream, reconnecting with capped
    exponential backoff (reference trace/backend.go:46-230: failed sends
    drop the connection and reconnect, waiting n*backoff up to the
    maximal backoff between attempts)."""

    def __init__(self, address, unix: bool = False,
                 backoff: float = 0.02, max_backoff: float = 0.5,
                 connect_budget: float = 2.0):
        self.address = address
        self.unix = unix
        self.backoff = backoff
        self.max_backoff = max_backoff
        self.connect_budget = connect_budget
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            if self.unix:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            else:
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.connect(self.address)
            self._sock = s
        return self._sock

    def _connect_with_backoff(self) -> socket.socket:
        """Reconnect, sleeping a growing (capped) backoff between
        attempts, bounded overall by connect_budget so the sender thread
        can surface a drop instead of stalling forever."""
        deadline = time.monotonic() + self.connect_budget
        wait = self.backoff
        while True:
            try:
                return self._connect()
            except OSError:
                self._drop()
                if time.monotonic() + wait > deadline:
                    raise
                time.sleep(wait)
                wait = min(wait * 2, self.max_backoff)

    def send(self, span: ssf.SSFSpan) -> None:
        # encode outside the retry: an over-size span raises FramingError
        # (an OSError subclass) and must not tear down a healthy socket
        frame = protocol.frame_ssf(span)
        with self._lock:
            try:
                self._connect().sendall(frame)
            except OSError:
                # drop the connection; retry on a fresh one with backoff
                self._drop()
                self._connect_with_backoff().sendall(frame)

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def flush(self) -> None:
        pass

    def close(self) -> None:
        with self._lock:
            self._drop()


class BufferedBackend:
    """Buffer spans in memory and write them in bursts — the reference's
    flushable buffered backend (trace/backend.go:63-118): sends cost an
    append; flush() (or a full buffer) drains the burst through the
    wrapped backend, so one reconnect covers a whole burst and a dead
    collector costs bounded memory."""

    def __init__(self, inner, capacity: int = 1024):
        self.inner = inner
        self.capacity = capacity
        self._buf: list = []
        self._lock = threading.Lock()
        self.dropped = 0

    def send(self, span: ssf.SSFSpan) -> None:
        with self._lock:
            self._buf.append(span)
            if len(self._buf) < self.capacity:
                return
            burst, self._buf = self._buf, []
        self._send_burst(burst)

    def _send_burst(self, burst) -> None:
        for s in burst:
            try:
                self.inner.send(s)
            except Exception:
                self.dropped += 1
                if self.dropped == 1:
                    logger.warning(
                        "buffered trace backend dropped its first span; "
                        "trace.spans_dropped counts the rest")

    def flush(self) -> None:
        with self._lock:
            burst, self._buf = self._buf, []
        self._send_burst(burst)
        self.inner.flush()

    def close(self) -> None:
        self.flush()
        self.inner.close()


# -- client --------------------------------------------------------------

class Client:
    """Buffered span reporter: `record` enqueues without blocking (drops
    and counts when the buffer is full), a sender thread drains to the
    backend (reference trace/client.go:56-170)."""

    def __init__(self, backend, capacity: int = 1024,
                 rng: Optional[random.Random] = None):
        self.backend = backend
        # span ids of start_span
        self.rng = rng if rng is not None else random.Random()
        self._q: "queue.Queue" = queue.Queue(maxsize=capacity)
        self.records_dropped = 0
        self.records_sent = 0
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="trace-client-sender", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            span = self._q.get()
            try:
                if span is None:
                    return
                try:
                    self.backend.send(span)
                    self.records_sent += 1
                except Exception as e:
                    self.records_dropped += 1
                    # log the first failure and then once per 100 so a
                    # dead backend is visible without flooding
                    if self.records_dropped == 1 or \
                            self.records_dropped % 100 == 0:
                        logger.warning(
                            "trace backend send failed (%d dropped): %s",
                            self.records_dropped, e)
            finally:
                self._q.task_done()

    def record(self, span: ssf.SSFSpan) -> None:
        if self._closed.is_set():
            self._count_drop()
            return
        try:
            self._q.put_nowait(span)
        except queue.Full:
            self._count_drop()

    def _count_drop(self) -> None:
        self.records_dropped += 1
        if self.records_dropped == 1:
            # once, then silently counted: surfaced as trace.spans_dropped
            # in the telemetry registry and /metrics
            logger.warning(
                "trace client dropped its first span (buffer full or "
                "closed); trace.spans_dropped counts the rest")

    @property
    def spans_dropped(self) -> int:
        """Total spans lost anywhere in the client: the bounded buffer's
        drops plus any the backend swallowed (BufferedBackend counts its
        failed sends on a bare attribute)."""
        return self.records_dropped + getattr(self.backend, "dropped", 0)

    def start_span(self, name: str, service: str = "",
                   tags: Optional[Dict[str, str]] = None,
                   parent: Optional[Span] = None,
                   indicator: bool = False) -> Span:
        if parent is not None:
            return Span(self, name, service or parent.proto.service,
                        trace_id=parent.trace_id, parent_id=parent.id,
                        tags=tags, indicator=indicator)
        return Span(self, name, service, tags=tags, indicator=indicator)

    def flush(self, timeout: float = 5.0) -> None:
        """Wait until every recorded span has been *processed* by the
        sender (not merely dequeued), bounded by `timeout`."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._q.all_tasks_done:
                if self._q.unfinished_tasks == 0:
                    break
            time.sleep(0.005)
        self.backend.flush()

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        self._q.put(None)
        self._thread.join(timeout=2.0)
        self.backend.close()
