"""Ingest listeners (the torch port of veneur_tpu/core/networking.py;
parity with reference networking.go:30-324 and socket_linux.go:12-30).

DogStatsD (`statsd_listen_addresses`):

- `udp://host:port` binds `num_readers` SO_REUSEPORT sockets on one port,
  so the kernel spreads datagrams over them by 4-tuple. With the native
  ingester the sockets belong to a C++ pump: one GIL-free reader thread
  per socket parses into chunks, and one Python thread dispatches the
  chunks into the column store. With the numpy decoder (`tpu.
  disable_native_parser: true`) each socket gets a Python reader thread
  that hands a batch of datagrams to `server.handle_packet_batch`.
- `tcp://host:port` takes newline-delimited lines, one thread per
  connection, each line through `server.handle_metric_packet`; with
  `tls_key` and `tls_certificate` the connections are TLS, and with
  `tls_authority_certificate` clients must present a certificate. A line
  longer than `metric_max_length` closes its connection (counted).
- `unix://path` or `unixgram://path` (`@name` for a Linux abstract
  socket) binds a UNIX datagram socket, read by a NativeReader into the
  native parser (or by Python into the numpy decoder).

SSF (`ssf_listen_addresses`): `udp://` carries one unframed span per
datagram, read in batches by a NativeReader (`read2`) into
`server.handle_ssf_buffer`, or with the numpy decoder by Python `recv`
into `handle_ssf_packet`; `unix://` and `tcp://` streams carry framed
spans (protocol.read_ssf, frames capped at `trace_max_length_bytes`),
where a framing error closes the connection and an undecodable frame is
counted and skipped.

Every UDP and TCP listener binds with SO_REUSEPORT, the SSF ones too
(the JAX package's SSF listeners do not), so a SIGUSR2 replacement
(core/restart.py) binds beside them; UNIX paths rebind with a gap.

Overload hooks (core/overload.py): every UDP socket (DogStatsD and SSF)
registers with the server's kernel-drop monitor, and each TCP line takes
one statsd admission token (an over-limit line keeps only its counter
and gauge samples).

Every datagram reader waits for data with a 500 ms poll and every
accept loop times out every 500 ms, so closing a listener needs no
wakeup (a shutdown() wakes neither a blocked recv on a UNIX datagram
socket nor a blocked accept on a UNIX listening socket on every host).
An unknown scheme raises with its name. Where
the JAX package falls back from a NativeReader that fails to build, the
port raises; a native batch
whose apply raises is counted as a dispatch error, which
`Server.flush()` re-raises (the JAX reader drops the batch's remainder).
"""

from __future__ import annotations

import ctypes
import logging
import os
import select
import socket
import ssl
import tempfile
import threading
from typing import List, Optional
from urllib.parse import urlparse

from veneur_tpu_torch import native, protocol
from veneur_tpu_torch.core.ingest import BatchIngester

logger = logging.getLogger("veneur_tpu_torch.networking")

_MAX_DGRAM = 65536
_MAX_BATCH = 512


def _new_udp_socket(host: str, port: int, rcvbuf: int) -> socket.socket:
    """SO_REUSEPORT + enlarged receive buffer (socket_linux.go:12-30)."""
    family = socket.AF_INET6 if ":" in host else socket.AF_INET
    sock = socket.socket(family, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    if rcvbuf:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
    sock.bind((host, port))
    return sock


def _unix_path(u) -> str:
    """A unix:// URL's socket path; `@name` is a Linux abstract socket
    (reference protocol/addr.go), whose address starts with a NUL byte.
    A stale file at a filesystem path is removed first."""
    path = u.path or u.netloc
    if path.startswith("@"):
        return "\0" + path[1:]
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    return path


class Listener:
    """The bound sockets of one address, the threads that read them (a
    pump and its dispatcher, or reader/accept threads), and for a stream
    listener its open connections."""

    def __init__(self, scheme: str, socks: List[socket.socket],
                 address=None):
        # "udp", "tcp", "unixgram", "ssf-udp", "ssf-tcp" or "ssf-unix",
        # as the JAX package names its listeners (Server.local_addr)
        self.scheme = scheme
        self.address = (address if address is not None
                        else socks[0].getsockname())
        self._socks = socks
        self._threads: List[threading.Thread] = []
        # a stream listener's open connections and their threads
        self._conns: dict = {}
        self._conns_lock = threading.Lock()
        self.pump = None  # set when the C++ pump owns the sockets
        self.closed = False

    def _spawn(self, target, args, name: str) -> threading.Thread:
        t = threading.Thread(target=target, args=args, name=name,
                             daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def _serve_connections(self, sock: socket.socket, handle,
                           name: str) -> None:
        """Accept loop of a stream listener: one thread per connection
        runs `handle(conn)`; the connection is tracked until it ends so
        close() can shut it down."""
        def run(conn):
            try:
                handle(conn)
            finally:
                with self._conns_lock:
                    self._conns.pop(conn, None)
                conn.close()

        def accept_loop():
            # a timed accept: shutdown() does not wake a blocked accept on
            # every kernel
            sock.settimeout(0.5)
            while not self.closed:
                try:
                    conn, _ = sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                thread = threading.Thread(target=run, args=(conn,),
                                          name=f"{name}-conn", daemon=True)
                with self._conns_lock:
                    if self.closed:
                        conn.close()
                        return
                    self._conns[conn] = thread
                thread.start()
        self._spawn(accept_loop, (), f"{name}-accept")

    def close(self) -> None:
        """Stop the readers, let a pump's dispatcher drain what they
        sealed, close the sockets. The pump joins its reader threads
        BEFORE the fds close (a reused fd number would let a reader poll
        someone else's socket). shutdown() wakes a blocked recv and ends
        the stream connections' reads; the native readers and the accept
        loops wake on their own timeouts and see `closed`."""
        self.closed = True
        if self.pump is not None:
            self.pump.stop()
        else:
            for sock in self._socks:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass  # ENOTCONN on a UDP or listening socket
        for t in self._threads:
            t.join(timeout=30.0)
        with self._conns_lock:
            conns = dict(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in conns.values():
            t.join(timeout=30.0)
        for sock in self._socks:
            sock.close()
        # the pump's native memory is freed by Pump.__del__ once the
        # dispatcher has dropped it: freeing here could race a dispatcher
        # that outlived the join


# -- DogStatsD -----------------------------------------------------------

def start_statsd(address: str, server, num_readers: int,
                 rcvbuf: int) -> Listener:
    """Start a DogStatsD listener for one address URL (reference
    networking.go:30-52 StartStatsd dispatch)."""
    u = urlparse(address)
    if u.scheme == "udp":
        return _start_statsd_udp(u, server, num_readers, rcvbuf)
    if u.scheme == "tcp":
        return _start_statsd_tcp(u, server)
    if u.scheme in ("unix", "unixgram"):
        return _start_statsd_unix(u, server)
    raise ValueError(f"unsupported statsd listen scheme {u.scheme!r} in "
                     f"{address!r}")


def _note_arrival_fn(server):
    """The server's sample-age stamp (core/latency.py note_arrival), or
    a no-op for a duck-typed server without an observatory."""
    latency = getattr(server, "latency", None)
    if latency is not None:
        return latency.note_arrival
    return lambda plane, n=1, t=None: None


def _watch_kernel_drops(server, socks, label: str) -> None:
    """Register bound UDP sockets with the overload manager's kernel-drop
    monitor (/proc/net/udp polled by inode), so receive-queue overflow
    the process never sees becomes `ingest.kernel_drops{listener}`."""
    for sock in socks:
        server.overload.kernel_drops.watch_socket(sock, label)


def _start_statsd_udp(u, server, num_readers: int, rcvbuf: int) -> Listener:
    host = u.hostname or "127.0.0.1"
    first = _new_udp_socket(host, u.port or 0, rcvbuf)
    bound_port = first.getsockname()[1]
    socks = [first] + [_new_udp_socket(host, bound_port, rcvbuf)
                       for _ in range(max(0, num_readers - 1))]
    listener = Listener("udp", socks)
    _watch_kernel_drops(server, socks, f"statsd-udp:{bound_port}")
    ing = server._ingester
    if isinstance(ing, BatchIngester):
        listener.pump = ing.start_pump(socks)
        listener._spawn(ing.run_pump_dispatch, (listener.pump, listener),
                        f"statsd-udp-pump-dispatch-{bound_port}")
        logger.info("listening for statsd on UDP %s (%d native readers, "
                    "C++ pump)", listener.address, len(socks))
        return listener
    for i, sock in enumerate(socks):
        listener._spawn(_read_metric_socket, (sock, server, listener),
                        f"statsd-udp-reader-{bound_port}-{i}")
    logger.info("listening for statsd on UDP %s (%d readers)",
                listener.address, len(socks))
    return listener


def _recv_batches(sock, listener: Listener, max_len: int):
    """Yield lists of queued datagrams: wait up to 500 ms for one to
    arrive (so close() needs no wakeup: a shutdown() does not wake a
    blocked recv on every socket type and kernel), then drain up to
    _MAX_BATCH without blocking. Ends when the listener closes or the
    socket fails. Empty datagrams are left out."""
    poller = select.poll()
    poller.register(sock.fileno(), select.POLLIN)
    while not listener.closed:
        if not poller.poll(500):
            continue
        batch = []
        while len(batch) < _MAX_BATCH:
            try:
                dgram = sock.recv(max_len, socket.MSG_DONTWAIT)
            except BlockingIOError:  # the queue is drained
                break
            except OSError:
                return
            if dgram:
                batch.append(dgram)
        if batch:
            yield batch


def _read_metric_socket(sock, server, listener: Listener) -> None:
    """Datagram read loop of the numpy-decoder path (reference
    server.go:1103-1140): each drained batch goes to
    server.handle_packet_batch."""
    for batch in _recv_batches(sock, listener, _MAX_DGRAM):
        server.handle_packet_batch(batch)


def _read_native_datagrams(sock, server, listener: Listener) -> None:
    """Datagram read loop of the native path: recvmmsg drains the queue
    into one newline-joined buffer that the batch parser reads in place;
    an oversized datagram is one rejected line. A batch whose apply
    raises is counted as a dispatch error."""
    max_len = server.config.metric_max_length
    reader = native.NativeReader(max_msgs=_MAX_BATCH, max_dgram=max_len + 1)
    ing = server._ingester
    fd = sock.fileno()
    note_arrival = _note_arrival_fn(server)
    while not listener.closed:
        length, _n, dropped = reader.read(fd, max_len)
        if length < 0:
            return
        if dropped:
            server.count_lines(dropped, 0)
        if length > 0:
            note_arrival("dogstatsd")  # one stamp per batch read
            try:
                ing.ingest_ptr(reader.buf_ptr, length)
            except Exception as e:  # surfaced by Server.flush/shutdown
                server.note_dispatch_error(e)
                logger.exception("UNIX datagram batch failed")


def build_tls_context(config) -> Optional[ssl.SSLContext]:
    """Server-side TLS context of the TCP listeners (reference
    server.go:569-627): `tls_key` + `tls_certificate` enable TLS,
    `tls_authority_certificate` also requires client certificates. Each
    value is inline PEM or a file path. Half a configuration raises."""
    key = config.tls_key.reveal()
    cert = config.tls_certificate
    if not key and not cert:
        if config.tls_authority_certificate:
            raise ValueError("tls_authority_certificate requires tls_key "
                             "and tls_certificate")
        return None
    if not key or not cert:
        raise ValueError(
            "tls_key and tls_certificate must both be set to enable TLS")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    with tempfile.TemporaryDirectory() as tmp:
        def materialize(pem_or_path: str, name: str) -> str:
            if "-----BEGIN" not in pem_or_path:
                return pem_or_path
            path = os.path.join(tmp, name)
            with open(path, "w") as f:
                f.write(pem_or_path)
            return path
        ctx.load_cert_chain(materialize(cert, "cert.pem"),
                            materialize(key, "key.pem"))
    ca = config.tls_authority_certificate
    if ca:
        ctx.verify_mode = ssl.CERT_REQUIRED
        if "-----BEGIN" in ca:
            ctx.load_verify_locations(cadata=ca)
        else:
            ctx.load_verify_locations(cafile=ca)
    return ctx


def _start_statsd_tcp(u, server) -> Listener:
    tls_ctx = build_tls_context(server.config)
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind((u.hostname or "127.0.0.1", u.port or 0))
    sock.listen(128)
    listener = Listener("tcp", [sock])

    def handle(conn):
        if tls_ctx is not None:
            # the handshake runs on the connection's thread (reference
            # server.go:1264-1293 handleTCPGoroutine)
            try:
                conn = tls_ctx.wrap_socket(conn, server_side=True)
            except (OSError, ssl.SSLError) as e:
                logger.warning("TLS handshake failed: %s", e)
                return
        with conn:
            _read_tcp_lines(conn, server, listener)

    listener._serve_connections(sock, handle,
                                f"statsd-tcp-{listener.address[1]}")
    logger.info("listening for statsd on TCP %s%s", listener.address,
                " (TLS)" if tls_ctx is not None else "")
    return listener


def _read_tcp_lines(conn, server, listener: Listener) -> None:
    """Newline-delimited stream reader (reference server.go:1323-1340),
    bounding a line at metric_max_length: a longer one is counted in
    `tcp_overlong_dropped` and closes the connection. The line is the
    unit of admission: one statsd token per line, and an over-limit line
    parses in essential-only mode (counter and gauge samples kept)."""
    max_len = server.config.metric_max_length
    admit = server.overload.admit_statsd_packet
    note_arrival = _note_arrival_fn(server)
    buf = b""
    while not listener.closed:
        try:
            chunk = conn.recv(65536)
        except OSError:
            return
        if not chunk:
            return
        note_arrival("dogstatsd")  # stamped per recv
        buf += chunk
        lines = buf.split(b"\n")
        buf = lines.pop()
        for line in lines:
            if line:
                server.handle_metric_packet(line,
                                            shed_nonessential=not admit())
        if len(buf) > max_len:
            with server._stats_lock:
                server.stats["tcp_overlong_dropped"] += 1
            logger.warning("dropping over-long TCP line (%d bytes)",
                           len(buf))
            return


def _start_statsd_unix(u, server) -> Listener:
    path = _unix_path(u)
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
    sock.bind(path)
    listener = Listener("unixgram", [sock], address=path)
    reader = (_read_native_datagrams
              if isinstance(server._ingester, BatchIngester)
              else _read_metric_socket)
    listener._spawn(reader, (sock, server, listener),
                    "statsd-unixgram-reader")
    logger.info("listening for statsd on UNIX datagram %r", path)
    return listener


# -- SSF -----------------------------------------------------------------

def start_ssf(address: str, server, rcvbuf: int) -> Listener:
    """Start an SSF listener for one address URL (reference
    networking.go:223-324 StartSSF)."""
    u = urlparse(address)
    if u.scheme == "udp":
        return _start_ssf_udp(u, server, rcvbuf)
    if u.scheme in ("unix", "tcp"):
        return _start_ssf_stream(u, server)
    raise ValueError(f"unsupported SSF listen scheme {u.scheme!r} in "
                     f"{address!r}")


def _start_ssf_udp(u, server, rcvbuf: int) -> Listener:
    # SO_REUSEPORT, unlike the JAX package's SSF listener: a SIGUSR2
    # replacement (core/restart.py) binds the same port beside this one
    sock = _new_udp_socket(u.hostname or "127.0.0.1", u.port or 0, rcvbuf)
    listener = Listener("ssf-udp", [sock])
    _watch_kernel_drops(server, [sock], f"ssf-udp:{listener.address[1]}")
    # the largest datagram read follows trace_max_length_bytes (reference
    # server.go:498's packet pool), clamped to the UDP ceiling
    max_read = min(max(int(server.config.trace_max_length_bytes), 1),
                   _MAX_DGRAM)
    reader = (_read_ssf_native
              if isinstance(server._ingester, BatchIngester)
              else _read_ssf_python)
    listener._spawn(reader, (sock, server, listener, max_read),
                    f"ssf-udp-reader-{listener.address[1]}")
    logger.info("listening for SSF on UDP %s", listener.address)
    return listener


def _read_ssf_native(sock, server, listener: Listener, max_read: int):
    """recvmmsg drain with per-datagram boundaries into the C++ SSF
    decode; an oversized datagram is one SSF parse error."""
    reader = native.NativeReader(max_msgs=256, max_dgram=max_read + 1)
    fd = sock.fileno()
    while not listener.closed:
        length, offs, lens, dropped = reader.read2(fd, max_read)
        if length < 0:
            return
        if dropped:
            server.count_ssf(dropped, dropped)
        if length > 0:
            try:
                server.handle_ssf_buffer(
                    ctypes.string_at(reader.buf_ptr, length), offs, lens)
            except Exception as e:  # surfaced by Server.flush/shutdown
                server.note_dispatch_error(e)
                logger.exception("SSF datagram batch failed")


def _read_ssf_python(sock, server, listener: Listener, max_read: int):
    for batch in _recv_batches(sock, listener, max_read):
        for packet in batch:
            server.handle_ssf_packet(packet)


def _start_ssf_stream(u, server) -> Listener:
    if u.scheme == "unix":
        path = _unix_path(u)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(path)
        address = path
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # for the SIGUSR2 handoff, as _start_ssf_udp
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind((u.hostname or "127.0.0.1", u.port or 0))
        address = sock.getsockname()
    sock.listen(128)
    listener = Listener(f"ssf-{u.scheme}", [sock], address=address)
    listener._serve_connections(
        sock, lambda conn: _read_ssf_frames(conn, server, listener),
        f"ssf-{u.scheme}")
    logger.info("listening for SSF on %s %r", u.scheme, address)
    return listener


def _read_ssf_frames(conn, server, listener: Listener) -> None:
    """Framed stream read loop (reference server.go:1200-1237): a
    framing error (or a frame over trace_max_length_bytes) closes the
    stream; an undecodable frame is counted and skipped."""
    max_len = int(server.config.trace_max_length_bytes)
    note_arrival = _note_arrival_fn(server)
    with conn.makefile("rb") as stream:
        while not listener.closed:
            try:
                span = protocol.read_ssf(stream, max_length=max_len)
            except protocol.SSFDecodeError as e:
                server.count_ssf(1, 1)
                logger.debug("dropping undecodable SSF span: %s", e)
                continue
            except protocol.FramingError as e:
                logger.warning("closing SSF stream on framing error: %s", e)
                return
            except OSError:
                return
            if span is None:
                return
            note_arrival("ssf")
            server.handle_ssf_span(span)
