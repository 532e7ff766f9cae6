"""Zero-gap graceful restart (port of veneur_tpu/core/restart.py): the
einhorn SIGUSR2 handoff rebuilt without a socket master (reference
server.go:1404, README.md:170-178).

The reference hands live fds to a replacement through einhorn. Here the
same zero-downtime property comes from SO_REUSEPORT: every UDP/TCP
listener (the SSF ones too, the HTTP API and the profile server) binds
with it, so on SIGUSR2 this process
spawns a replacement from its own argv, the replacement binds the same
addresses while the old one still serves, and once the replacement
reports ready (/healthcheck/ready) the old process shuts down — the
listeners close, the native ingest pump drains, and (with
flush_on_shutdown) the partial interval flushes. At no point is there no
listener on the port.

Caveats, by design: UNIX-path listeners rebind with a brief gap
(filesystem binds are exclusive); the handoff interval's counters are
split across two flushes (they sum correctly downstream — same property
as the reference's handoff).
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

logger = logging.getLogger("veneur_tpu_torch.restart")

READY_TIMEOUT_S = 60.0
# env var through which the replacement reports "listeners bound": the
# child writes its pid to this path at the end of Server.start(). Used
# when no HTTP readiness endpoint is configured — a merely-alive child
# wedged in startup must NOT win the handoff (draining for it leaves
# the port unserved, worse than refusing the restart).
READY_FILE_ENV = "VENEUR_TPU_READY_FILE"


_in_progress = threading.Lock()


def install(shutdown, http_address: str = "", argv=None) -> None:
    """Handle SIGUSR2 with a spawn-replacement-then-drain handoff.

    Explicit contract (no server duck-typing): `shutdown` is called once
    the replacement is ready; `http_address` is the readiness endpoint
    the replacement will serve. Without an http_address the handoff
    falls back to a ready-file handshake (the replacement writes its pid
    once its listeners are bound, Server.start()); a replacement that
    never reports bound — even one still alive — loses the handoff and
    the old process keeps serving. Must be called from the main thread
    (signal module contract)."""
    if not http_address:
        logger.info(
            "graceful restart installed without a readiness endpoint: "
            "SIGUSR2 handoffs will use the ready-file handshake "
            "(replacement reports once its listeners are bound)")

    def handler(signum, frame):
        if not _in_progress.acquire(blocking=False):
            logger.warning("SIGUSR2 ignored: a handoff is in progress")
            return

        def run():
            try:
                _restart(shutdown, http_address, argv)
            finally:
                _in_progress.release()

        t = threading.Thread(target=run, name="graceful-restart",
                             daemon=True)
        t.start()

    signal.signal(signal.SIGUSR2, handler)


def mark_ready() -> None:
    """Report "listeners bound" to a parent mid-SIGUSR2 handoff: write
    our pid to the ready file it named in the environment. Called by
    Server.start() and the proxy CLI once every listener is up; a no-op
    outside a handoff."""
    ready_file = os.environ.pop(READY_FILE_ENV, "")
    if not ready_file:
        return
    # popped above: the handshake is single-use — inheriting the env var
    # would make descendants re-create the (by then unlinked) /tmp path
    # with open('w') later, the symlink-following TOCTOU the mkstemp in
    # _restart exists to avoid
    try:
        with open(ready_file, "w") as f:
            f.write(str(os.getpid()))
    except OSError:
        logger.exception("could not write restart ready-file")


def respawn_argv(argv=None):
    argv = list(sys.argv if argv is None else argv)
    if argv and os.access(argv[0], os.X_OK) and not argv[0].endswith(".py"):
        return argv  # console-script shim: exec it directly
    # `python -m veneur_tpu_torch.cmd.veneur`: argv[0] is the module
    # FILE, and re-running it as a script would lose the package on
    # sys.path — respawn through -m with the original module name instead
    import __main__
    spec = getattr(__main__, "__spec__", None)
    if spec is not None and spec.name:
        return [sys.executable, "-m", spec.name] + argv[1:]
    return [sys.executable] + argv


def _restart(shutdown, http_address: str, argv) -> None:
    cmd = respawn_argv(argv)
    logger.info("SIGUSR2: spawning replacement process: %s", cmd)
    ready_file = ""
    env = None
    if not http_address:
        import tempfile
        # the mkstemp-owned (0600) file stays in place — unlinking and
        # letting the child re-create the path would hand a
        # world-writable-dir TOCTOU to anyone watching TMPDIR. The file
        # stays empty until the replacement truncate-writes its pid.
        fd, ready_file = tempfile.mkstemp(prefix="veneur-ready-")
        os.close(fd)
        env = dict(os.environ, **{READY_FILE_ENV: ready_file})
    try:
        child = subprocess.Popen(cmd, env=env)
    except Exception:
        logger.exception("replacement spawn failed; keeping this process")
        if ready_file:
            try:
                os.unlink(ready_file)
            except OSError:
                pass
        return
    ok = _wait_ready(http_address, child, ready_file=ready_file)
    if ready_file:
        try:
            os.unlink(ready_file)
        except OSError:
            pass
    if not ok:
        if child.poll() is None:
            logger.error("replacement not ready after %.0fs; keeping "
                         "this process (replacement left running)",
                         READY_TIMEOUT_S)
        else:
            logger.error("replacement exited rc=%s before becoming "
                         "ready; keeping this process", child.returncode)
        return
    logger.info("replacement ready (pid %d); draining and exiting",
                child.pid)
    shutdown()


def _wait_ready(addr: str, child, timeout: float = READY_TIMEOUT_S,
                ready_file: str = "") -> bool:
    if not addr:
        # no readiness endpoint: wait for the ready-file handshake — the
        # replacement writes its pid once Server.start() has bound the
        # listeners. Alive-but-wedged is NOT ready.
        deadline = time.time() + timeout
        while time.time() < deadline:
            if child.poll() is not None:
                return False
            try:
                with open(ready_file) as f:
                    if f.read().strip() == str(child.pid):
                        return True
            except OSError:
                pass
            time.sleep(0.25)
        return False
    host, _, port = addr.rpartition(":")
    url = f"http://{host or '127.0.0.1'}:{port}/healthcheck/ready"
    deadline = time.time() + timeout
    while time.time() < deadline:
        if child.poll() is not None:
            return False
        try:
            with urllib.request.urlopen(url, timeout=2) as resp:
                # the kernel load-balances REUSEPORT connections over
                # every listener on the port: ours, and any other
                # process's that bound it too. Only the replacement's
                # own ready answer counts (the JAX package takes any
                # pid but ours, and so hands off to a stranger)
                pid = resp.headers.get("X-Veneur-Pid", "")
                if resp.status == 200 and pid == str(child.pid):
                    return True
        except Exception:
            pass
        time.sleep(0.5)
    return False
