"""The port's graceful restart (core/restart.py) against the JAX package's
cases (tests/test_restart.py), on the CPU: SIGUSR2 spawns a replacement
that binds beside the old process through SO_REUSEPORT; the old process
drains and exits only after the replacement answers /healthcheck/ready
(or, without an HTTP API, writes the ready file). The subprocess case
runs the port's CLI with `-device cpu`. Every subprocess wait has its
own timeout.

Also here: the CLI's crash reporting with a stubbed `sentry_sdk`, and the
SSF listeners' SO_REUSEPORT (a replacement binds a fixed SSF port beside
the old process)."""

from __future__ import annotations

import logging
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request

import pytest

from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core import restart
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink
from veneur_tpu_torch.util import crash

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ephemeral_low() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port(kind=socket.SOCK_STREAM) -> int:
    """A free 127.0.0.1 port below the kernel's ephemeral range. The
    kernel hands no such port to a bind to port 0 or to an outgoing
    connection, so no other test can take it between this check and the
    server's own bind (a port 0 pick, closed and bound again later, can
    be taken in that gap, and the servers under test bind with
    SO_REUSEPORT, so they would share it with the taker)."""
    rng = random.Random(os.getpid() ^ time.time_ns())
    for _ in range(500):
        port = rng.randrange(10000, _ephemeral_low())
        try:
            for k in (socket.SOCK_STREAM, socket.SOCK_DGRAM):
                with socket.socket(socket.AF_INET, k) as s:
                    s.bind(("127.0.0.1", port))
        except OSError:
            continue
        return port
    raise RuntimeError("no free port below the ephemeral range")


def ready_pid(port: int):
    """The answering pid, or None when not ready."""
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthcheck/ready",
                timeout=2) as r:
            if r.status == 200:
                return int(r.headers.get("X-Veneur-Pid", "0"))
    except Exception:
        return None
    return None


class TestInstallContract:
    """restart.install's explicit (shutdown, http_address) contract, the
    seam both CLIs depend on."""

    def test_ready_handoff_calls_shutdown(self, monkeypatch):
        calls = []

        class FakeChild:
            pid = 4242

            def poll(self):
                return None

        monkeypatch.setattr(restart.subprocess, "Popen",
                            lambda cmd, env=None: FakeChild())
        monkeypatch.setattr(restart, "_wait_ready",
                            lambda addr, child, timeout=0, ready_file="": (
                                calls.append(("ready", addr)) or True))
        restart._restart(lambda: calls.append(("shutdown",)),
                         "127.0.0.1:9999", ["prog"])
        assert ("ready", "127.0.0.1:9999") in calls
        assert ("shutdown",) in calls

    def test_unready_replacement_keeps_the_old_process(self, monkeypatch):
        calls = []

        class FakeChild:
            pid = 4242
            returncode = 1

            def poll(self):
                return 1  # the replacement died

        monkeypatch.setattr(restart.subprocess, "Popen",
                            lambda cmd, env=None: FakeChild())
        restart._restart(lambda: calls.append("shutdown"),
                         "127.0.0.1:9999", ["prog"])
        assert calls == []

    def test_no_http_uses_ready_file_handshake(self, tmp_path):
        class DeadChild:
            pid = 1111

            def poll(self):
                return 1

        class LiveChild:
            pid = 2222

            def poll(self):
                return None

        rf = str(tmp_path / "ready")
        assert restart._wait_ready("", DeadChild(), timeout=0.3,
                                   ready_file=rf) is False
        assert restart._wait_ready("", LiveChild(), timeout=0.5,
                                   ready_file=rf) is False
        with open(rf, "w") as f:
            f.write("2222")
        assert restart._wait_ready("", LiveChild(), timeout=2.0,
                                   ready_file=rf) is True
        with open(rf, "w") as f:
            f.write("9999")
        assert restart._wait_ready("", LiveChild(), timeout=0.5,
                                   ready_file=rf) is False

    def test_http_handoff_waits_for_the_replacements_own_pid(self):
        """Another process that shares the readiness port through
        SO_REUSEPORT answers ready with its own pid: that answer never
        wins the handoff, only the replacement's own does."""
        import http.server

        def answering(pid):
            class Ready(http.server.BaseHTTPRequestHandler):
                def do_GET(self):
                    self.send_response(200)
                    self.send_header("X-Veneur-Pid", str(pid))
                    self.send_header("Content-Length", "0")
                    self.end_headers()

                def log_message(self, *args):
                    pass
            return Ready

        class LiveChild:
            pid = 424242

            def poll(self):
                return None

        port = free_port()
        servers = []
        try:
            for pid in (31337, LiveChild.pid):
                server = http.server.HTTPServer(
                    ("127.0.0.1", port), answering(pid),
                    bind_and_activate=False)
                server.socket.setsockopt(socket.SOL_SOCKET,
                                         socket.SO_REUSEPORT, 1)
                server.server_bind()
                server.server_activate()
                threading.Thread(target=server.serve_forever,
                                 kwargs={"poll_interval": 0.05},
                                 daemon=True).start()
                servers.append(server)
                if len(servers) == 1:
                    # a stranger alone on the port: never ready
                    assert restart._wait_ready(f"127.0.0.1:{port}",
                                               LiveChild(),
                                               timeout=1.5) is False
            # the replacement beside the stranger: ready once its own
            # answer comes back
            assert restart._wait_ready(f"127.0.0.1:{port}", LiveChild(),
                                       timeout=30.0) is True
        finally:
            for server in servers:
                server.shutdown()
                server.server_close()

    def test_restart_ready_file_wedged_child_loses(self, monkeypatch):
        spawned = {}

        class WedgedChild:
            pid = 7777

            def poll(self):
                return None

        def fake_popen(cmd, env=None):
            spawned["cmd"], spawned["env"] = cmd, env
            return WedgedChild()

        monkeypatch.setattr(restart.subprocess, "Popen", fake_popen)
        real_wait = restart._wait_ready
        monkeypatch.setattr(
            restart, "_wait_ready",
            lambda addr, child, ready_file="": real_wait(
                addr, child, timeout=0.6, ready_file=ready_file))
        calls = []
        restart._restart(lambda: calls.append("shutdown"), "", ["prog"])
        assert calls == []
        ready_file = spawned["env"][restart.READY_FILE_ENV]
        assert ready_file.startswith("/") and not os.path.exists(ready_file)

    def test_restart_ready_file_bound_child_wins(self, monkeypatch):
        spawned = {}

        class BoundChild:
            pid = 8888

            def poll(self):
                with open(spawned["env"][restart.READY_FILE_ENV], "w") as f:
                    f.write(str(self.pid))
                return None

        def fake_popen(cmd, env=None):
            spawned["env"] = env
            return BoundChild()

        monkeypatch.setattr(restart.subprocess, "Popen", fake_popen)
        real_wait = restart._wait_ready
        monkeypatch.setattr(
            restart, "_wait_ready",
            lambda addr, child, ready_file="": real_wait(
                addr, child, timeout=5.0, ready_file=ready_file))
        calls = []
        restart._restart(lambda: calls.append("shutdown"), "", ["prog"])
        assert calls == ["shutdown"]
        assert not os.path.exists(spawned["env"][restart.READY_FILE_ENV])

    def test_mark_ready_is_single_use(self, tmp_path, monkeypatch):
        rf = tmp_path / "ready"
        monkeypatch.setenv(restart.READY_FILE_ENV, str(rf))
        restart.mark_ready()
        assert rf.read_text() == str(os.getpid())
        assert restart.READY_FILE_ENV not in os.environ
        rf.unlink()
        restart.mark_ready()
        assert not rf.exists()

    def test_server_start_writes_ready_file(self, tmp_path, monkeypatch):
        rf = str(tmp_path / "ready")
        monkeypatch.setenv("VENEUR_TPU_READY_FILE", rf)
        cfg = config_from_dict({"interval": "1h",
                                "statsd_listen_addresses":
                                    ["udp://127.0.0.1:0"]})
        server = Server(cfg, device="cpu",
                        extra_metric_sinks=[ChannelMetricSink()])
        server.start()
        try:
            with open(rf) as f:
                assert f.read().strip() == str(os.getpid())
        finally:
            server.shutdown()


class _SlowSink:
    """A sink whose every delivery takes `seconds`."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.received = []

    def name(self):
        return "slow"

    def start(self, server):
        pass

    def stop(self):
        pass

    def flush(self, metrics):
        time.sleep(self.seconds)
        self.received.extend(sorted(m.name for m in metrics))

    def flush_other_samples(self, samples):
        pass


def test_shutdown_delivers_the_last_interval_behind_a_slow_sink():
    """The old process's shutdown in a handoff: the sink's delivery of
    the previous interval outlasts that flush's deadline and still runs
    when shutdown starts. The last flush waits for it instead of skipping
    the sink as a pileup, and shutdown returns only once the last
    interval was delivered."""
    sink = _SlowSink(0.8)
    cfg = config_from_dict({
        "interval": "0.3s", "flush_on_shutdown": True, "tpu": dict(
            counter_capacity=64, gauge_capacity=64, histo_capacity=64,
            set_capacity=32, batch_cap=256)})
    server = Server(cfg, device="cpu", extra_metric_sinks=[sink])
    server.handle_metric_packet(b"before:1|c")
    server.flush()
    # the delivery of `before` is still running past the flush
    assert sink.received == []
    server.handle_metric_packet(b"last:1|c")
    server.shutdown()
    assert sink.received == ["before", "last"]
    assert server.stats_snapshot().get(
        "flush.sink_skipped_total#sink:metric:slow", 0) == 0


def test_respawn_argv_respawns_the_port_module(monkeypatch):
    import __main__
    spec = types.SimpleNamespace(name="veneur_tpu_torch.cmd.veneur")
    monkeypatch.setattr(__main__, "__spec__", spec, raising=False)
    argv = ["/x/veneur_tpu_torch/cmd/veneur.py", "-f", "c.yaml",
            "-device", "cpu"]
    assert restart.respawn_argv(argv) == [
        sys.executable, "-m", "veneur_tpu_torch.cmd.veneur", "-f",
        "c.yaml", "-device", "cpu"]


def test_ssf_listeners_bind_beside_a_replacement():
    """A replacement binds the same fixed SSF UDP and TCP ports while the
    old server still holds them (the JAX package's SSF listeners bind
    without SO_REUSEPORT, so its replacement fails to start)."""
    udp, tcp = free_port(socket.SOCK_DGRAM), free_port()
    servers = []
    try:
        for _ in range(2):
            cfg = config_from_dict({"interval": "1h", "ssf_listen_addresses": [
                f"udp://127.0.0.1:{udp}", f"tcp://127.0.0.1:{tcp}"]})
            server = Server(cfg, device="cpu",
                            extra_metric_sinks=[ChannelMetricSink()])
            server.start()
            servers.append(server)
        for server in servers:
            assert [lis.address[1] for lis in server._ssf_listeners] == \
                [udp, tcp]
    finally:
        for server in servers:
            server.shutdown()


class _StubSentry(types.ModuleType):
    def __init__(self):
        super().__init__("sentry_sdk")
        self.inits, self.captured = [], []

    def init(self, dsn=None):
        self.inits.append(dsn)

    def capture_exception(self, exc):
        self.captured.append(exc)


@pytest.fixture
def clean_reporting():
    root = logging.getLogger()
    handlers = list(root.handlers)
    crash.clear_reporters()
    yield
    crash.clear_reporters()
    root.handlers[:] = handlers


def test_sentry_dsn_reports_errors_and_panics(monkeypatch,
                                              clean_reporting):
    from veneur_tpu_torch.cmd import veneur as cli
    stub = _StubSentry()
    monkeypatch.setitem(sys.modules, "sentry_sdk", stub)
    cfg = config_from_dict({"sentry_dsn": "https://key@sentry.invalid/1"})
    cli.install_crash_reporting(cfg, logging.getLogger("veneur"))
    assert stub.inits == ["https://key@sentry.invalid/1"]
    logging.getLogger("veneur_tpu_torch.test").error("flush failed")
    assert [str(e) for e in stub.captured] == ["flush failed"]
    boom = ValueError("panic")
    with pytest.raises(ValueError):
        crash.consume_panic(boom)
    assert stub.captured[-1] is boom


def test_sentry_dsn_without_sentry_sdk_warns(monkeypatch, caplog,
                                             clean_reporting):
    from veneur_tpu_torch.cmd import veneur as cli
    monkeypatch.setitem(sys.modules, "sentry_sdk", None)  # ImportError
    cfg = config_from_dict({"sentry_dsn": "https://key@sentry.invalid/1"})
    with caplog.at_level(logging.WARNING):
        cli.install_crash_reporting(cfg, logging.getLogger("veneur"))
    assert "sentry-sdk is unavailable" in caplog.text
    assert crash._reporters == []


def test_no_sentry_dsn_registers_no_reporter(monkeypatch, clean_reporting):
    from veneur_tpu_torch.cmd import veneur as cli
    stub = _StubSentry()
    monkeypatch.setitem(sys.modules, "sentry_sdk", stub)
    cli.install_crash_reporting(config_from_dict({}),
                                logging.getLogger("veneur"))
    assert stub.inits == [] and crash._reporters == []
    assert any(isinstance(h, crash.ReportingHandler)
               for h in logging.getLogger().handlers)


@pytest.mark.skipif(not hasattr(socket, "SO_REUSEPORT"),
                    reason="needs SO_REUSEPORT")
def test_sigusr2_hands_off_without_dropping_the_listener(tmp_path):
    udp_port, http_port = free_port(socket.SOCK_DGRAM), free_port()
    cfg = tmp_path / "veneur.yaml"
    cfg.write_text(
        "statsd_listen_addresses:\n"
        f"  - udp://127.0.0.1:{udp_port}\n"
        f"http_address: \"127.0.0.1:{http_port}\"\n"
        "interval: 1.0\n"
        "flush_on_shutdown: true\n"
        "stats_address: \"\"\n"
        "metric_sinks:\n"
        "  - kind: blackhole\n"
        "    name: blackhole\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    old = subprocess.Popen(
        [sys.executable, "-m", "veneur_tpu_torch.cmd.veneur", "-f",
         str(cfg), "-device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    new_pid = None
    try:
        deadline = time.time() + 90
        while time.time() < deadline and ready_pid(http_port) != old.pid:
            assert old.poll() is None, old.stderr.read()[-3000:]
            time.sleep(0.5)
        assert ready_pid(http_port) == old.pid, "server never became ready"

        old.send_signal(signal.SIGUSR2)
        deadline = time.time() + 120
        while time.time() < deadline:
            pid = ready_pid(http_port)
            if pid and pid != old.pid:
                new_pid = pid
                break
            time.sleep(0.5)
        assert new_pid, "replacement never became ready"
        assert old.wait(timeout=60) == 0
        deadline = time.time() + 10
        pid = None
        while time.time() < deadline:
            pid = ready_pid(http_port)
            if pid:
                break
            time.sleep(0.2)
        assert pid == new_pid
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.sendto(b"restart.probe:1|c", ("127.0.0.1", udp_port))
        assert ready_pid(http_port) == new_pid
    finally:
        for pid in {new_pid, old.pid if old.poll() is None else None}:
            if pid:
                try:
                    os.kill(pid, signal.SIGTERM)
                except OSError:
                    pass
        try:
            old.wait(timeout=10)
        except Exception:
            old.kill()
            old.wait(timeout=10)
        if new_pid:
            deadline = time.time() + 30
            while time.time() < deadline:
                try:
                    os.kill(new_pid, 0)
                except OSError:
                    break
                time.sleep(0.2)
            else:
                os.kill(new_pid, signal.SIGKILL)
