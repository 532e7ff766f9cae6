"""DogStatsD UDP listeners (the pure-Python read path of
veneur_tpu/core/networking.py; parity with reference networking.go:30-52
and socket_linux.go:12-30).

Each `udp://host:port` address gets one socket and one reader thread.
The thread blocks for a datagram, drains what else is queued without
blocking, and hands the batch to `server.handle_packet_batch`.
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import List
from urllib.parse import urlparse

logger = logging.getLogger("veneur_tpu_torch.networking")

_MAX_DGRAM = 65536
_MAX_BATCH = 512


def _new_udp_socket(host: str, port: int, rcvbuf: int) -> socket.socket:
    """SO_REUSEPORT + enlarged receive buffer (socket_linux.go:12-30)."""
    family = socket.AF_INET6 if ":" in host else socket.AF_INET
    sock = socket.socket(family, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if hasattr(socket, "SO_REUSEPORT"):
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    if rcvbuf:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
    sock.bind((host, port))
    return sock


class Listener:
    """One bound UDP socket and the thread that reads it."""

    def __init__(self, sock: socket.socket, server):
        self.address = sock.getsockname()
        self._sock = sock
        self.closed = False
        self._thread = threading.Thread(
            target=self._read_loop, args=(server,),
            name=f"statsd-udp-{self.address[1]}", daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the reader and close the socket. On Linux, shutdown()
        of a UDP socket wakes a blocked recv with an empty read (and
        reports ENOTCONN, which is expected here)."""
        self.closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._thread.join(timeout=5.0)
        self._sock.close()

    def _read_loop(self, server) -> None:
        """Datagram read loop (reference server.go:1103-1140)."""
        sock = self._sock
        while not self.closed:
            try:
                buf = sock.recv(_MAX_DGRAM)
            except OSError:
                return
            if not buf:
                continue
            batch: List[bytes] = [buf]
            while len(batch) < _MAX_BATCH:
                try:
                    batch.append(sock.recv(_MAX_DGRAM, socket.MSG_DONTWAIT))
                except OSError:  # BlockingIOError: the queue is drained
                    break
            server.handle_packet_batch(batch)


def start_statsd(address: str, server, rcvbuf: int) -> Listener:
    """Start a DogStatsD listener for one `udp://` address URL."""
    u = urlparse(address)
    if u.scheme != "udp":
        raise ValueError(f"unsupported statsd listen scheme {u.scheme!r} "
                         f"in {address!r}: veneur_tpu_torch listens on "
                         f"udp:// only")
    listener = Listener(
        _new_udp_socket(u.hostname or "127.0.0.1", u.port or 0, rcvbuf),
        server)
    logger.info("listening for statsd on UDP %s", listener.address)
    return listener
