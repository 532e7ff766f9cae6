"""DogStatsD UDP listeners (the UDP part of veneur_tpu/core/networking.py;
parity with reference networking.go:30-52 and socket_linux.go:12-30).

Each `udp://host:port` address binds `num_readers` SO_REUSEPORT sockets
on one port, so the kernel spreads datagrams over them by 4-tuple (one
sender socket lands on one reader). With the native ingester the sockets
belong to a C++ pump: one GIL-free reader thread per socket parses into
chunks, and one Python thread dispatches the chunks into the column
store. With the numpy decoder (`tpu.disable_native_parser: true`) each
socket gets a Python reader thread that drains a batch of datagrams and
hands it to `server.handle_packet_batch`.
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import List
from urllib.parse import urlparse

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


class Listener:
    """The bound UDP sockets of one address and the threads that read
    them (a pump and its dispatcher, or one Python reader per socket)."""

    def __init__(self, socks: List[socket.socket]):
        self.address = socks[0].getsockname()
        self._socks = socks
        self._threads: List[threading.Thread] = []
        self.pump = None  # set when the C++ pump owns the sockets
        self.closed = False

    def _spawn(self, target, args, name: str) -> None:
        t = threading.Thread(target=target, args=args, name=name,
                             daemon=True)
        t.start()
        self._threads.append(t)

    def close(self) -> None:
        """Stop the readers, let the dispatcher drain what they sealed,
        close the sockets. The pump joins its reader threads BEFORE the
        fds close (a reused fd number would let a reader poll someone
        else's socket). On Linux, shutdown() of a UDP socket wakes a
        blocked recv with an empty read (and reports ENOTCONN, which is
        expected here)."""
        self.closed = True
        if self.pump is not None:
            self.pump.stop()
        else:
            for sock in self._socks:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        for t in self._threads:
            t.join(timeout=30.0)
        for sock in self._socks:
            sock.close()
        # the pump's native memory is freed by Pump.__del__ once the
        # dispatcher has dropped it: freeing here could race a dispatcher
        # that outlived the join


def start_statsd(address: str, server, num_readers: int,
                 rcvbuf: int) -> Listener:
    """Start a DogStatsD listener for one `udp://` address URL."""
    u = urlparse(address)
    if u.scheme != "udp":
        raise ValueError(f"unsupported statsd listen scheme {u.scheme!r} "
                         f"in {address!r}: veneur_tpu_torch listens on "
                         f"udp:// only")
    return _start_statsd_udp(u, server, num_readers, rcvbuf)


def _start_statsd_udp(u, server, num_readers: int, rcvbuf: int) -> Listener:
    host = u.hostname or "127.0.0.1"
    first = _new_udp_socket(host, u.port or 0, rcvbuf)
    bound_port = first.getsockname()[1]
    socks = [first] + [_new_udp_socket(host, bound_port, rcvbuf)
                       for _ in range(max(0, num_readers - 1))]
    listener = Listener(socks)
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


def _read_metric_socket(sock, server, listener: Listener) -> None:
    """Datagram read loop of the numpy-decoder path (reference
    server.go:1103-1140): block for a datagram, drain what else is queued
    without blocking, hand the batch to server.handle_packet_batch."""
    while not listener.closed:
        try:
            buf = sock.recv(_MAX_DGRAM)
        except OSError:
            return
        if not buf:
            continue
        batch = [buf]
        while len(batch) < _MAX_BATCH:
            try:
                batch.append(sock.recv(_MAX_DGRAM, socket.MSG_DONTWAIT))
            except OSError:  # BlockingIOError: the queue is drained
                break
        server.handle_packet_batch(batch)
