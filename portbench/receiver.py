"""A loopback stand-in for the Datadog intake, run as a child process so
that its request handling takes no turns of the benchmarked process's
interpreter lock.

Protocol on the child's standard streams: it prints its port as the first
line of stdout, then reads commands from stdin, one a line:

  cut     close the current group of bodies (the harness sends it after
          each flush has joined its sinks) and open the next
  end     write every group to stdout and exit: per group a line
          `group <n>` and per body a line `body <len>` followed by the
          raw (gzip) bytes, then `done`

A POST to /api/v1/series is answered 202 and its raw body kept in memory.
Other paths are answered 202 and counted but not kept.
"""

from __future__ import annotations

import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _Store:
    def __init__(self):
        self.lock = threading.Lock()
        self.groups = [[]]
        self.other = 0

    def add(self, body: bytes) -> None:
        with self.lock:
            self.groups[-1].append(body)

    def cut(self) -> None:
        with self.lock:
            self.groups.append([])


def _handler(store: _Store):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):  # noqa: N802 (http.server's naming)
            n = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(n)
            if self.path.startswith("/api/v1/series"):
                store.add(body)
            else:
                with store.lock:
                    store.other += 1
            self.send_response(202)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

        do_PUT = do_POST

        def log_message(self, *args):
            pass

    return Handler


def main() -> int:
    store = _Store()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _handler(store))
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    out = sys.stdout.buffer
    out.write(b"%d\n" % httpd.server_address[1])
    out.flush()
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "cut":
            store.cut()
        elif cmd == "end":
            break
    httpd.shutdown()
    httpd.server_close()
    with store.lock:
        groups = store.groups
    for i, group in enumerate(groups):
        out.write(b"group %d\n" % i)
        for body in group:
            out.write(b"body %d\n" % len(body))
            out.write(body)
    out.write(b"done\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
