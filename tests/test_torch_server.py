"""The port's server over real UDP on the CPU, its device policy, its
config surface, and its independence from JAX and veneur_tpu."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.device import pick_device
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(**extra):
    raw = {"statsd_listen_addresses": ["udp://127.0.0.1:0"],
           "interval": "1h", "percentiles": [0.5, 0.99],
           "aggregates": ["min", "max", "count"], "hostname": "test",
           "tpu": {"counter_capacity": 16, "gauge_capacity": 16,
                   "histo_capacity": 16, "set_capacity": 16,
                   "batch_cap": 32, "set_promote_samples": 4}}
    raw.update(extra)
    return config_from_dict(raw)


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_udp_server_on_cpu_flushes_expected_series():
    sink = ChannelMetricSink()
    server = Server(_config(), device="cpu", extra_metric_sinks=[sink])
    server.start()
    try:
        addr = server.listen_addresses[0]
        lines = [b"hits:1|c", b"hits:2|c|@0.5", b"temp:20|g", b"temp:21.5|g",
                 b"lat:10|ms", b"lat:30|ms", b"lat:20|ms",
                 b"bad-line", b"ll:4|l", b"_sc|svc|1"]
        lines += [b"users:u%d|s" % i for i in range(6)]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            tx.sendto(b"\n".join(lines[:8]), addr)
            for line in lines[8:]:
                tx.sendto(line, addr)
        assert _wait_for(
            lambda: server.stats_snapshot()["lines_received"] == len(lines))
        server.flush()
        got = {m.name: m.value for m in sink.wait_flush(timeout=10)}
    finally:
        server.shutdown()
    stats = server.stats_snapshot()
    assert stats["lines_rejected"] == 1
    assert stats["lines_parsed"] == len(lines) - 1
    assert stats["llhist_rejected"] == 1
    assert got["hits"] == 5.0  # 1 + trunc(2 / 0.5)
    assert got["temp"] == 21.5
    assert (got["lat.min"], got["lat.max"], got["lat.count"]) == (
        10.0, 30.0, 3.0)
    assert got["lat.50percentile"] == pytest.approx(20.0)
    assert 20.0 < got["lat.99percentile"] <= 30.0
    assert got["users"] == 6.0
    assert got["svc"] == 1.0
    assert "ll" not in got and "ll.50percentile" not in got


def test_device_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert pick_device(None) == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pick_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(_config())
    assert pick_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("key,value", [
    ("forward_address", "127.0.0.1:8128"),
    ("ssf_listen_addresses", ["udp://127.0.0.1:0"]),
    ("grpc_address", "127.0.0.1:0"),
    ("tpu", {"shards": 4}),
])
def test_config_rejects_features_the_port_lacks(key, value):
    with pytest.raises(ValueError, match=key if key != "tpu" else "shards"):
        config_from_dict({key: value})


def test_cli_validates_config(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("interval: 5s\npercentiles: [0.5]\n")
    bad = tmp_path / "bad.yaml"
    bad.write_text("forward_address: x:1\n")
    from veneur_tpu_torch.cmd import veneur
    assert veneur.main(["-f", str(cfg), "-validate-config"]) == 0
    assert veneur.main(["-f", str(bad), "-validate-config"]) == 1


def test_port_imports_neither_jax_nor_veneur_tpu():
    code = r"""
import importlib, pkgutil, sys
import veneur_tpu_torch
for mod in pkgutil.walk_packages(veneur_tpu_torch.__path__,
                                 "veneur_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "veneur_tpu" or n.startswith("veneur_tpu."))
assert not bad, bad
print("ok", len([n for n in sys.modules if n.startswith("veneur_tpu_torch")]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
