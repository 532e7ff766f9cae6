"""The port's server over real UDP on the CPU, its device policy, its
config surface, and its independence from JAX and veneur_tpu."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core import flusher
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.device import pick_device
from veneur_tpu_torch.ops import hll_ref, llhist_ref
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
    assert stats["unknown_rejected"] == 0  # `|l` has its family now
    assert stats["llhist_samples"] == 1
    assert got["hits"] == 5.0  # 1 + trunc(2 / 0.5)
    assert got["temp"] == 21.5
    assert (got["lat.min"], got["lat.max"], got["lat.count"]) == (
        10.0, 30.0, 3.0)
    assert got["lat.50percentile"] == pytest.approx(20.0)
    assert 20.0 < got["lat.99percentile"] <= 30.0
    assert got["users"] == 6.0
    assert got["svc"] == 1.0
    assert got["ll.count"] == 1.0 and got["ll.bucket"] == 1.0
    assert 4.0 <= got["ll.50percentile"] <= 4.1


def _circllhist_corpus():
    """Lines of every family for a circllhist server, and the reference
    series computed with llhist_ref / hll_ref from exactly what is sent."""
    rng = np.random.default_rng(11)
    lines, want, llhists = [], {}, {}
    for k in range(6):
        vals = rng.lognormal(0, 4, 40) * rng.choice([-1, 1], 40)
        vals[:2] = (1e-12, 3e16)  # collapsed to zero / clamped to the top
        rate = 0.5 if k % 2 else 1.0
        suffix = "|@0.5" if k % 2 else ""
        lines += [f"l{k}:{v:.6g}|l{suffix}" for v in vals]
        llhists[f"l{k}"] = (np.array([float(f"{v:.6g}") for v in vals]),
                            round(1 / rate))
        tvals = rng.gamma(2.0, 20.0, 25)
        lines += [f"t{k}:{v:.3f}|ms" for v in tvals]
        llhists[f"t{k}"] = (np.array([float(f"{v:.3f}") for v in tvals]), 1)
        lines += [f"c{k}:{k + 1}|c", f"c{k}:{k + 2}|c|@0.5"]
        want[f"c{k}"] = float(k + 1 + 2 * (k + 2))
        lines.append(f"g{k}:{k * 1.5}|g")
        want[f"g{k}"] = k * 1.5
        h = hll_ref.HLL()
        for j in range(5 + k):
            lines.append(f"s{k}:m{j}|s")
            h.insert(f"m{j}".encode())
        want[f"s{k}"] = float(hll_ref.estimate_from_registers(h.regs))
    for name, (vals, weight) in llhists.items():
        bins = np.zeros(llhist_ref.BINS, np.int64)
        np.add.at(bins, llhist_ref.bin_index(vals), weight)
        csum = np.cumsum(bins[llhist_ref.ORDER])
        nz = np.flatnonzero(bins[llhist_ref.ORDER])
        want[f"{name}.count"] = float(bins.sum())
        want[f"{name}.sum"] = float(bins.astype(np.float64)
                                    @ llhist_ref.BIN_MID)
        for i in nz.tolist():
            want[(f"{name}.bucket",
                  f"le:{flusher._fmt_le(llhist_ref.UPPER_SORTED[i])}")] = \
                float(csum[i])
        want[(f"{name}.bucket", "le:+Inf")] = float(bins.sum())
        for p, q in zip((0.5, 0.99), llhist_ref.quantiles(bins, (0.5, 0.99))):
            want[f"{name}.{int(p * 100)}percentile"] = float(q)
    order = rng.permutation(len(lines))
    return [lines[i].encode() for i in order], want


def _run_circllhist_server(disable_native: bool):
    lines, _ = _circllhist_corpus()
    sink = ChannelMetricSink()
    cfg = _config(histogram_encoding="circllhist", num_readers=2,
                  tpu={"counter_capacity": 4, "gauge_capacity": 4,
                       "histo_capacity": 4, "set_capacity": 4,
                       "llhist_capacity": 4, "batch_cap": 64,
                       "disable_native_parser": disable_native})
    server = Server(cfg, device="cpu", extra_metric_sinks=[sink])
    server.start()
    try:
        addr = server.listen_addresses[0]
        socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                 for _ in range(4)]
        for i in range(0, len(lines), 20):  # 4 senders: both readers
            socks[(i // 20) % 4].sendto(b"\n".join(lines[i:i + 20]), addr)
        for s in socks:
            s.close()
        assert _wait_for(
            lambda: server.stats_snapshot()["lines_received"] == len(lines))
        server.flush()
        got = {}
        for m in sink.wait_flush(timeout=10):
            le = [t for t in m.tags if t.startswith("le:")]
            got[(m.name, le[0]) if le else m.name] = m.value
    finally:
        server.shutdown()
    stats = server.stats_snapshot()
    assert stats["lines_rejected"] == 0 and stats["unknown_rejected"] == 0
    assert stats["ingest_dispatch_errors"] == 0
    assert stats["llhist_clamped"] == 2 * 3 + 2 * 3 * 2  # rates 1 and 0.5
    return got


@pytest.mark.parametrize("disable_native", [False, True],
                         ids=["native_pump", "numpy_decoder"])
def test_circllhist_server_flushes_the_reference_series(disable_native):
    _, want = _circllhist_corpus()
    got = _run_circllhist_server(disable_native)
    assert set(got) == set(want)
    for key, value in want.items():
        if "percentile" in str(key):
            # float32 ranks and interpolation on the device side
            assert got[key] == pytest.approx(value, rel=1e-5), key
        elif str(key).endswith(".sum"):
            assert got[key] == pytest.approx(value, rel=1e-12), key
        else:
            assert got[key] == value, key


def test_native_pump_and_numpy_decoder_flush_identical_series():
    assert _run_circllhist_server(False) == _run_circllhist_server(True)


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
    ("forward_tls_certificate", "cert.pem"),
    ("ssf_listen_addresses", ["udp://127.0.0.1:0"]),
    ("grpc_tls_certificate", "cert.pem"),
    ("tpu", {"shards": 4}),
])
def test_config_rejects_features_the_port_lacks(key, value):
    with pytest.raises(ValueError, match=key if key != "tpu" else "shards"):
        config_from_dict({key: value})


def test_cli_validates_config(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("interval: 5s\npercentiles: [0.5]\n")
    bad = tmp_path / "bad.yaml"
    bad.write_text("forward_only: true\n")
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
