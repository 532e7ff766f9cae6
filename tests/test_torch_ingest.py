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
from veneur_tpu_torch.config import config_from_dict as tconfig_from_dict
from veneur_tpu_torch.core.ledger import FlowLedger as TLedger
from veneur_tpu_torch.core.overload import OverloadManager as TOverload
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


_KINDS = (("c", 0), ("g", 1), ("ms", 2), ("h", 2), ("s", 3), ("l", 4))


def _keyed(n: int, prefix: str = "k"):
    """`n` distinct keys over every family, with tags and sample rates:
    (line, meta key, family, rate), the line's value chunk one to three
    values (timers and histograms) or a set member."""
    out = []
    for i in range(n):
        kind, family = _KINDS[i % len(_KINDS)]
        rate = 0.5 if i % 5 == 0 and kind != "g" else 1.0
        tail = (f"|{kind}" + ("|@0.5" if rate != 1.0 else "")
                + f"|#env:e{i % 3},endpoint:/api/v1/ep{i % 512}")
        name = f"{prefix}.metric.{i}"
        if kind == "s":
            value = f"m{i % 7}"
        elif kind in ("ms", "h"):
            value = ":".join(f"{(i * j * 37) % 1000 / 8}"
                             for j in range(1, 2 + i % 3))
        else:
            value = f"{(i * 37) % 1000 / 8}"
        out.append((f"{name}:{value}{tail}".encode(),
                    f"{name}{tail}".encode(), family, rate))
    return out


def _register(parsers, keyed, first_row: int = 0) -> None:
    for row, (_line, meta, family, rate) in enumerate(keyed, first_row):
        for parser in parsers:
            parser.engine.register(meta, family, row, rate)


def _same_columns(parsers, buf: bytes) -> dict:
    jparse, tparse = parsers
    want, got = _columns(jparse.parse(buf)), _columns(tparse.parse(buf))
    assert got == want
    return want


# lines the native parse hands to the slow path without a lookup
_NO_LOOKUP = [b"_e{5,4}:title|text", b"_sc|svc.ok|0", b"no_pipe_here",
              b"no_colon|c"]
# lines whose key resolves but whose values fail, rolled back
_ROLLED_BACK = [b"k.metric.0:1:x|c|@0.5|#env:e0,endpoint:/api/v1/ep0",
                b"k.metric.3:1::2|h|#env:e0,endpoint:/api/v1/ep3"]


def _window_buffer(n_lines: int) -> bytes:
    """`n_lines` non-empty lines across the parse window's edges: keyed,
    unknown, rolled-back, gauge and no-lookup lines, blank lines between
    them and at the front, and a trailing newline."""
    rng = np.random.default_rng(n_lines)
    pool = ([line for line, *_ in _keyed(48)]
            + [line for line, *_ in _keyed(6, prefix="unknown")]
            + _NO_LOOKUP + _ROLLED_BACK)
    lines = [pool[i] for i in rng.integers(0, len(pool), n_lines)]
    out = [b""]
    for i, line in enumerate(lines):
        out.append(line)
        if i % 4 == 1:
            out.append(b"")
    return b"\n".join(out) + b"\n"


@pytest.mark.parametrize("case", [
    "grow_40k", "lines_1", "lines_15", "lines_16", "lines_17", "lines_33",
    "registered_twice", "swept_and_recycled", "near_keys"])
def test_native_table_gives_the_jax_columns(case):
    """The port's flat intern table and windowed parse against the JAX
    package's native parser, on what the table and the window change:
    growth, the window's edges, re-registration, the sweep and keys that
    share all but a byte."""
    parsers = (jnative.NativeParser(engine=jnative.Engine()),
               tnative.NativeParser(engine=tnative.Engine()))
    tengine = parsers[1].engine
    if case == "grow_40k":
        keyed = _keyed(40_000)
        _register(parsers, keyed)
        assert tengine.stats()["capacity"] == 2 ** 17  # seven doublings
        lines = ([line for line, *_ in keyed]
                 + [line for line, *_ in _keyed(2000, prefix="unknown")]
                 + _NO_LOOKUP)
        order = np.random.default_rng(1).permutation(len(lines))
        want = _same_columns(parsers, b"\n".join(lines[i] for i in order))
        assert len(want["unknown"]) == 2000 + len(_NO_LOOKUP)
    elif case.startswith("lines_"):
        n_lines = int(case.split("_")[1])
        _register(parsers, _keyed(48))
        for reps in (1, 2):  # a second buffer through the same parser
            want = _same_columns(parsers, _window_buffer(n_lines) * reps)
            assert want["lines"] == n_lines * reps
    elif case == "registered_twice":
        keyed = _keyed(300)
        _register(parsers, keyed)
        again = [(line, meta, family, 0.25) for line, meta, family, _rate
                 in keyed[::3]]
        _register(parsers, again, first_row=1000)
        assert tengine.size() == 300
        want = _same_columns(parsers, b"\n".join(k[0] for k in keyed))
        rows = set(want["c_rows"] + want["h_rows"] + want["s_rows"]
                   + want["g_rows"] + want["l_rows"])
        assert {1000, 1099} <= rows and 0 not in rows and 1 in rows
    elif case == "swept_and_recycled":
        keyed = _keyed(3000)
        _register(parsers, keyed)
        buf = b"\n".join(k[0] for k in keyed)
        _same_columns(parsers, buf)
        swept = [(family, row) for row, (_l, _m, family, _r)
                 in enumerate(keyed) if row % 3 == 0]
        for parser in parsers:
            parser.engine.unregister_rows_multi(swept)
        assert tengine.size() == 2000
        recycled = _keyed(3000, prefix="recycled")[::3]
        for (family, row), (_line, meta, _f, rate) in zip(swept, recycled):
            for parser in parsers:
                parser.engine.register(meta, family, row, rate)
        want = _same_columns(
            parsers, buf + b"\n" + b"\n".join(k[0] for k in recycled))
        assert want["unknown"] == [k[0] for k in keyed[::3]]
        assert tengine.size() == 3000
    else:  # near_keys: the last byte of the name, or only the tags
        near = []
        for i in range(64):
            for last in "ab":
                near.append((f"near.x{i}{last}:1|c|#env:e0".encode(),
                             f"near.x{i}{last}|c|#env:e0".encode(), 0, 1.0))
            for env in ("e0", "e1"):
                near.append((f"near.y{i}:2|c|#env:{env}".encode(),
                             f"near.y{i}|c|#env:{env}".encode(), 0, 1.0))
        _register(parsers, near[::2])
        want = _same_columns(parsers, b"\n".join(k[0] for k in near))
        assert want["unknown"] == [k[0] for k in near[1::2]]
        assert want["c_rows"] == list(range(len(near) // 2))


def test_native_lookups_are_counted():
    """`ParseResult`'s lookups, misses and probe steps, and
    `Engine.stats()`, on a corpus whose hits and misses are known."""
    parser = tnative.NativeParser(engine=tnative.Engine())
    engine = parser.engine
    assert engine.stats() == dict(size=0, capacity=1024, arena_bytes=0,
                                  lookups=0, misses=0, probes=0)
    keyed = _keyed(6000)
    _register([parser], keyed[:5000])
    stats = engine.stats()
    assert stats["size"] == 5000 and stats["capacity"] == 16_384
    assert stats["arena_bytes"] == sum(len(k[1]) for k in keyed[:5000])

    mixed = parser.parse(b"\n".join([k[0] for k in keyed] + _NO_LOOKUP
                                    + [b""]))
    assert (mixed.lookups, mixed.misses) == (6000, 1000)
    assert mixed.probes >= mixed.lookups + mixed.misses
    hits = parser.parse(b"\n".join(k[0] for k in keyed[:5000]))
    assert (hits.lookups, hits.misses) == (5000, 0)
    assert hits.lookups <= hits.probes <= 1.5 * hits.lookups
    stats = engine.stats()
    assert (stats["lookups"], stats["misses"], stats["probes"]) == (
        11_000, 1000, mixed.probes + hits.probes)

    engine.unregister_rows_multi(
        [(family, row) for row, (_l, _m, family, _r)
         in enumerate(keyed[:1000])])
    stats = engine.stats()
    assert stats["size"] == 4000 and stats["capacity"] == 16_384
    assert stats["arena_bytes"] == sum(len(k[1]) for k in keyed[1000:5000])
    swept = parser.parse(b"\n".join(k[0] for k in keyed[:2000]))
    assert (swept.lookups, swept.misses) == (2000, 1000)


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
    """The same stand-in for the port's Server, with the overload plane
    a default config builds (it admits everything) and a disabled flow
    ledger."""

    def __init__(self, store):
        self.store = store
        self.parser = TParser()
        self.lines = [0, 0]
        self.overload = TOverload(tconfig_from_dict({}))
        self.ledger = TLedger(enabled=False)

    def ingest_metric(self, metric):
        self.store.process(metric)

    _ingest_metric_essential = ingest_metric

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
