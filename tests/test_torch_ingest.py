"""The batch ingest plane of veneur_tpu_torch against the JAX package's:
the native C++ parser and the numpy columnar decoder give the same
columns, and each package's own ingester, fed the same packets, lands
them in a circllhist column store that flushes the same series."""

from __future__ import annotations

import numpy as np
import pytest

from veneur_tpu import native as jnative
from veneur_tpu.core import batchdecode as jdecode
from veneur_tpu.core.columnstore import ColumnStore as JStore
from veneur_tpu.core.flusher import flush_columnstore_batch as jflush
from veneur_tpu.core.ingest import BatchIngester as JBatch
from veneur_tpu.core.ingest import PyBatchIngester as JPyBatch
from veneur_tpu.samplers.metrics import HistogramAggregates as JAggs
from veneur_tpu.samplers.parser import ParseError as JParseError
from veneur_tpu.samplers.parser import Parser as JParser
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.core import batchdecode as tdecode
from veneur_tpu_torch.core.columnstore import ColumnStore as TStore
from veneur_tpu_torch.core.flusher import flush_columnstore_batch as tflush
from veneur_tpu_torch.core.ingest import BatchIngester as TBatch
from veneur_tpu_torch.core.ingest import PyBatchIngester as TPyBatch
from veneur_tpu_torch.samplers.metrics import HistogramAggregates as TAggs
from veneur_tpu_torch.samplers.parser import ParseError as TParseError
from veneur_tpu_torch.samplers.parser import Parser as TParser

PS = [0.5, 0.9, 0.99]
AGGS = ["min", "max", "count"]
SIZES = dict(counter_capacity=8, gauge_capacity=8, histo_capacity=8,
             set_capacity=8, llhist_capacity=8, batch_cap=64,
             set_promote_samples=4, histogram_encoding="circllhist")
FAMILY = {"c": 0, "g": 1, "h": 2, "d": 2, "m": 2, "s": 3, "l": 4}
COLUMNS = ("c_rows", "c_vals", "c_rates", "g_rows", "g_vals", "g_lines",
           "h_rows", "h_vals", "h_wts", "s_rows", "s_idx", "s_rho",
           "l_rows", "l_bins", "l_wts", "l_clamped", "unknown",
           "unknown_lines", "lines", "samples")


def _corpus(seed: int, num_keys: int = 12):
    """All five families with rates and tags, llhist values across and
    outside the bin window (clamped, zero, negative), multi-value lines,
    malformed and unknown lines, events and service checks."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(num_keys):
        lines.append(f"c{i}:{rng.integers(1, 50)}|c|@0.5|#t:{i % 3}")
        lines.append(f"c{i}:{rng.integers(1, 50)}|c|#t:{i % 3}")
        lines.append(f"g{i}:{rng.normal():.4f}|g")
        lines.append(f"g{i}:{rng.normal():.4f}|g")
        for _ in range(int(rng.integers(1, 20))):
            lines.append(f"t{i}:{rng.gamma(2, 10):.3f}|ms|#t:{i % 2}")
        lines.append(f"h{i}:{rng.gamma(2, 10):.3f}:{rng.gamma(2, 10):.3f}"
                     f"|h|@0.25")
        for j in range(int(rng.integers(1, 12))):
            lines.append(f"s{i}:m{j}|s")
        vals = rng.lognormal(0, 5, 20) * rng.choice([-1, 1], 20)
        for v in vals:
            lines.append(f"l{i}:{v:.6g}|l" + ("|@0.5" if i % 2 else ""))
    lines += ["l_edge:0|l", "l_edge:1e-12|l", "l_edge:-2e-10|l",
              "l_edge:1e17|l", "l_edge:-3e16|l", "l_edge:100|l",
              "t_local:5|h|#veneurlocalonly", "l_glob:7|l|#veneurglobalonly",
              "bad:abc|c", "bad_set|s", "_sc|svc.ok|0|m:all good",
              "_e{5,4}:title|text", "nan:nan|g"]
    order = rng.permutation(len(lines))
    return [lines[i].encode() for i in order]


def _register_all(corpus, engines, skip_every=5):
    """Register every metric key of the corpus but every fifth with both
    packages' intern tables (same family, row and rate)."""
    parser = JParser()
    row = 0
    for line in corpus:
        if line.startswith((b"_e{", b"_sc")):
            continue
        try:
            parser.parse_metric_fast(line, lambda m: None)
        except JParseError:
            continue
        type_start = line.find(b"|")
        meta_key = line[:line.find(b":")] + line[type_start:]
        cached = parser._meta_cache.get(meta_key)
        if cached is None or row % skip_every == skip_every - 1:
            row += 1
            continue
        family = FAMILY[chr(line[type_start + 1])]
        for engine in engines:
            engine.register(meta_key, family, row, cached[3])
        row += 1


def _columns(res):
    out = {}
    for name in COLUMNS:
        value = getattr(res, name)
        out[name] = (list(value) if name == "unknown"
                     else np.asarray(value).tolist())
    return out


@pytest.mark.parametrize("kind", ["native", "numpy"])
def test_parsers_give_the_jax_columns(kind):
    corpus = _corpus(0)
    buf = b"\n".join(corpus)
    if kind == "native":
        jparse = jnative.NativeParser(engine=jnative.Engine())
        tparse = tnative.NativeParser(engine=tnative.Engine())
        engines = (jparse.engine, tparse.engine)
    else:
        jparse, tparse = jdecode.ColumnarDecoder(), tdecode.ColumnarDecoder()
        engines = (jparse, tparse)
    _register_all(corpus, engines)
    want, got = _columns(jparse.parse(buf)), _columns(tparse.parse(buf))
    assert got == want
    assert want["l_clamped"] > 0 and len(want["l_rows"]) > 100
    assert len(want["unknown"]) > 10 and len(want["s_rows"]) > 0


class _Stats(dict):
    def inc(self, key, n=1):
        self[key] = self.get(key, 0) + n


class _JaxServer:
    """The smallest stand-in for veneur_tpu's Server that its ingesters
    need: a store, a parser, stats and the slow-path entry points."""

    def __init__(self, store):
        self.store = store
        self.parser = JParser()
        self.stats = _Stats()
        self.ingest_metric = store.process

    def handle_metric_packet(self, line):
        try:
            if line.startswith(b"_sc"):
                self.store.process(self.parser.parse_service_check(line))
            elif not line.startswith(b"_e{"):
                self.parser.parse_metric_fast(line, self.store.process)
        except JParseError:
            self.stats.inc("parse_errors")


class _PortServer:
    """The same stand-in for the port's Server."""

    def __init__(self, store):
        self.store = store
        self.parser = TParser()
        self.lines = [0, 0]

    def count_lines(self, received, parsed):
        self.lines[0] += received
        self.lines[1] += parsed

    def handle_metric_packet(self, line):
        parsed = 1
        try:
            if line.startswith(b"_sc"):
                self.store.process(self.parser.parse_service_check(line))
            elif not line.startswith(b"_e{"):
                self.parser.parse_metric_fast(line, self.store.process)
        except TParseError:
            parsed = 0
        self.count_lines(1, parsed)


def _series(batch):
    return {(m.name, tuple(m.tags), m.type.name): m.value
            for m in batch.materialize()}


@pytest.mark.parametrize("kind", ["native", "numpy"])
def test_ingesters_flush_the_jax_series(kind):
    jstore, tstore = JStore(**SIZES), TStore(device="cpu", **SIZES)
    jserver, tserver = _JaxServer(jstore), _PortServer(tstore)
    if kind == "native":
        jing, ting = JBatch(jserver), TBatch(tserver)
    else:
        jing, ting = JPyBatch(jserver), TPyBatch(tserver)
    for seed in (0, 1):  # the second interval runs on the recycled spare
        corpus = _corpus(seed)
        # in datagram-sized buffers; the repeat takes the columnar path
        # for every key the first pass interned
        for _ in range(2):
            for start in range(0, len(corpus), 40):
                buf = b"\n".join(corpus[start:start + 40])
                jing.ingest_buffer(buf)
                ting.ingest_buffer(buf)
        jbatch, _ = jflush(jstore, False, PS, JAggs.from_names(AGGS))
        tbatch, _ = tflush(tstore, False, PS, TAggs.from_names(AGGS))
        want, got = _series(jbatch), _series(tbatch)
        assert set(got) == set(want)
        for key, value in want.items():
            if "percentile" in key[0]:
                np.testing.assert_allclose(got[key], value, rtol=1e-6,
                                           err_msg=str(key))
            elif not key[0].endswith(".sum"):
                # counters, gauges, sets, .count and every .bucket line
                assert got[key] == value, key
            else:
                np.testing.assert_allclose(got[key], value, rtol=1e-12,
                                           err_msg=str(key))
        assert len(tbatch) == len(jbatch)
        assert any(k[0].endswith(".bucket") for k in want)
    assert tstore.llhists.samples_total == jstore.llhists.samples_total
    assert tstore.llhists.clamped_total == jstore.llhists.clamped_total > 0
    assert tstore.processed == jstore.processed
    # every line counted once (each corpus went in twice): received =
    # columnar + slow path, and only the malformed lines are rejected
    assert tserver.lines[0] == 2 * sum(len(_corpus(s)) for s in (0, 1))
    assert tserver.lines[0] - tserver.lines[1] == 2 * 2 * 3
    # under circllhist the port registers timer keys as llhist keys, so
    # they take the columnar path; the JAX package leaves them deferred
    tsize = (ting._engine.size() if kind == "native"
             else ting.decoder.size())
    jsize = (jing._engine.size() if kind == "native"
             else jing.decoder.size())
    assert tsize == jsize + 2 * 12 + 1  # t0..t11, h0..h11, t_local


def test_native_build_failure_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    bad = tmp_path / "dogstatsd.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        tnative.build()
    assert not list((tmp_path / "build").glob("*.so"))  # no half library
    monkeypatch.setattr(tnative.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.build()


def test_pump_dispatch_error_is_counted_and_raised(monkeypatch):
    import socket
    import time

    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.core.server import Server

    cfg = config_from_dict({"statsd_listen_addresses": ["udp://127.0.0.1:0"],
                            "interval": "1h", "hostname": "test"})
    server = Server(cfg, device="cpu")

    def broken(res):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(server._ingester, "_ingest", broken)
    server.start()
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            tx.sendto(b"a:1|c", server.listen_addresses[0])
        deadline = time.monotonic() + 10
        while (server.stats_snapshot()["ingest_dispatch_errors"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert server.stats_snapshot()["ingest_dispatch_errors"] == 1
        with pytest.raises(RuntimeError, match="failed to apply") as info:
            server.flush()
        assert "kernel launch failed" in str(info.value.__cause__)
    finally:
        with pytest.raises(RuntimeError, match="failed to apply"):
            server.shutdown()
