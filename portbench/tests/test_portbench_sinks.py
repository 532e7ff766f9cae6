"""The split of a flush's sink time in the harness: the two readers of
the sinks' `sink:<name>` records on a synthetic record (each None where
no sink reports its part), and a traced run on the CPU, which reads both
without arming the program's span recorder, and reads no `sinks_gzip_s`
from a program whose sinks do not report the gzip."""

import time

import pytest

from portbench import run as prun, spec
from portbench.tests.small import small_cell

NEW = ("sinks_encode_s", "sinks_gzip_s")


def _sink(encode_s, send_s, gzip_s):
    return {"status": "ok", "duration_s": 1.0, "cpu_s": 0.5,
            "encode_s": encode_s, "send_s": send_s,
            "encoder": "columnar", "gzip_s": gzip_s}


def _run():
    return {"flush_timings": [
        {"sinks_s": 1.0, "sink:datadog": _sink(0.020, 0.030, 0.012),
         "sink:other": _sink(0.004, 0.001, 0.002)},
        # a sink thread that delivered nothing reports no egress
        {"sinks_s": 1.0, "sink:datadog": _sink(0.010, 0.006, 0.004),
         "sink:other": _sink(None, None, None)},
        {"sinks_s": 0.0, "span_sink:x": _sink(9.0, 9.0, 9.0)}]}


@pytest.mark.parametrize("metric,want", [
    ("sinks_encode_s", (0.020 + 0.004 + 0.010) / 3),
    ("sinks_gzip_s", (0.012 + 0.002 + 0.004) / 3),
])
def test_reader_on_a_synthetic_record(metric, want):
    read = spec.reader(metric)
    assert read(_run()) == pytest.approx(want, rel=1e-12)
    assert read({"flush_timings": [{"sinks_s": 1.0}]}) is None
    assert read({"flush_timings": []}) is None


def test_gzip_absent_where_the_sink_does_not_split_it():
    run = {"flush_timings": [{"sink:datadog": {
        "encode_s": 0.5, "send_s": 0.25, "encoder": "columnar"}}]}
    assert spec.reader("sinks_encode_s")(run) == 0.5
    assert spec.reader("sinks_gzip_s")(run) is None


def _traced_metrics():
    line = prun.run_cell(small_cell(), 2**31 + 17, 3.0, True, "cpu",
                         device="cpu", t_start=time.perf_counter())
    assert line["correct"] is True, line["checks"]
    return line["metrics"]


def test_traced_run_reads_the_split_unarmed(monkeypatch):
    from veneur_tpu_torch.core import profiling

    def arm(*_a, **_kw):
        raise AssertionError("the harness armed the span recorder")
    monkeypatch.setattr(profiling, "arm", arm)
    metrics = _traced_metrics()
    assert set(NEW) <= set(metrics)
    assert 0 < metrics["sinks_gzip_s"]["value"]
    assert metrics["sinks_encode_s"]["value"] + \
        metrics["sinks_gzip_s"]["value"] <= \
        metrics["flush_sinks_s"]["value"]


def test_program_without_the_gzip_split_reads_no_sinks_gzip_s(
        monkeypatch):
    from veneur_tpu_torch.sinks import MetricSink
    note = MetricSink.note_egress

    def note_egress(self, encode_s, send_s, encoder="columnar",
                    gzip_s=None):
        note(self, encode_s, send_s, encoder)
    monkeypatch.setattr(MetricSink, "note_egress", note_egress)
    metrics = _traced_metrics()
    assert "sinks_encode_s" in metrics
    assert "sinks_gzip_s" not in metrics
