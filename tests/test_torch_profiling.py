"""The port's profiling plane (core/profiling.py) against the JAX
package's (tests/test_profiling.py's nine cases), on the CPU.

The pprof family returns valid gzipped pprof protos (gzip magic,
decompresses, the top-level Profile fields `go tool pprof` needs: sample
type 1, string table 6 with "" first, period 12), and `encode_pprof` on
fixed stacks and a pinned clock is byte-identical to the JAX package's.
The device trace is torch.profiler's Chrome trace, zipped; here it is
the CPU profiler's (a server on the CPU traces no device), readable
with every member's CRC intact. A capture on a card whose host records
no device event answers 503 naming the reason; the profile server port
serves the same capture."""

import gzip
import io
import json
import urllib.error
import urllib.request
import zipfile

import pytest

from veneur_tpu.core import profiling as jprofiling
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core import profiling
from veneur_tpu_torch.core.httpapi import HTTPApi
from veneur_tpu_torch.util.protowire import read_fields


def _get(api_or_addr, path, timeout=30.0):
    host, port = getattr(api_or_addr, "address", api_or_addr)
    host = "127.0.0.1" if host == "0.0.0.0" else host
    try:
        with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def parse_pprof(body: bytes) -> dict:
    """Decompress + parse the top-level Profile fields; returns
    {field_number: [values]}. Raises on anything malformed."""
    assert body[:2] == b"\x1f\x8b", "pprof payload must be gzipped"
    raw = gzip.decompress(body)
    assert raw, "empty profile proto"
    fields: dict = {}
    for num, _wt, value in read_fields(raw):
        fields.setdefault(num, []).append(value)
    return fields


def assert_valid_profile(body: bytes, want_samples: bool = True):
    fields = parse_pprof(body)
    assert 1 in fields, "profile has no sample_type"
    assert 6 in fields, "profile has no string_table"
    assert 12 in fields, "profile has no period"
    if want_samples:
        assert 2 in fields, "profile recorded no samples"
        assert 4 in fields and 5 in fields
    assert fields[6][0] == b""
    return fields


def assert_readable_zip(body: bytes) -> zipfile.ZipFile:
    zf = zipfile.ZipFile(io.BytesIO(body))
    assert zf.namelist(), "device trace zip is empty"
    assert zf.testzip() is None  # every member's CRC checks out
    return zf


class TestPprofFunctions:
    def test_cpu_profile_is_valid_pprof(self):
        assert_valid_profile(profiling.pprof_for(0.15))

    def test_threads_profile_is_valid_pprof(self):
        assert_valid_profile(profiling.threads_pprof())

    def test_heap_profile_is_valid_pprof(self):
        body, _fresh = profiling.heap_pprof_or_cached()
        assert_valid_profile(body, want_samples=False)

    def test_empty_profile_is_valid(self):
        assert_valid_profile(profiling.empty_pprof("mutex"),
                             want_samples=False)

    def test_device_trace_is_readable_zip(self):
        zf = assert_readable_zip(profiling.capture_device_trace(0.2, "cpu"))
        assert set(zf.namelist()) == {"trace.json", "summary.json"}
        summary = json.loads(zf.read("summary.json"))
        assert summary["activities"] == ["CPU"]
        assert summary["device_events"] == 0
        assert "traceEvents" in json.loads(zf.read("trace.json"))


class TestPprofEndpoints:
    def _start(self):
        api = HTTPApi(config_from_dict({}), address="127.0.0.1:0")
        api.start()
        return api

    def test_profile_endpoint(self):
        api = self._start()
        try:
            status, body = _get(api, "/debug/pprof/profile?seconds=0.2")
            assert status == 200
            assert_valid_profile(body)
        finally:
            api.stop()

    def test_heap_endpoint(self):
        api = self._start()
        try:
            status, body = _get(api, "/debug/pprof/heap")
            # the arming throttle with nothing cached yet is the one
            # other answer, as in the JAX package
            assert status in (200, 429)
            if status == 200:
                assert_valid_profile(body, want_samples=False)
        finally:
            api.stop()

    def test_goroutine_endpoint(self):
        api = self._start()
        try:
            status, body = _get(api, "/debug/pprof/goroutine")
            assert status == 200
            fields = assert_valid_profile(body)
            # at least this test's thread and the HTTP server thread
            assert len(fields[2]) >= 2
        finally:
            api.stop()

    def test_device_trace_endpoint_zip(self):
        api = self._start()
        try:
            status, body = _get(api, "/debug/profile/device?seconds=0.2")
            assert status == 200
            assert_readable_zip(body)
        finally:
            api.stop()


def test_encode_pprof_is_byte_identical_to_jax(monkeypatch):
    stacks = {
        (("a.py", "leaf", 12), ("a.py", "mid", 3), ("b.py", "root", 1)):
            [5, 5_000_000],
        (("a.py", "leaf", 14), ("b.py", "root", 1)): [2, 2_000_000],
        (("c.py", "other", 7),): [1, 1_000_000],
    }
    types = [("samples", "count"), ("cpu", "nanoseconds")]
    for mod in (profiling, jprofiling):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_001.5)
    got = profiling.encode_pprof(stacks, types, ("cpu", "nanoseconds"),
                                 10_000_000, 1_700_000_000.0)
    want = jprofiling.encode_pprof(stacks, types, ("cpu", "nanoseconds"),
                                   10_000_000, 1_700_000_000.0)
    assert gzip.decompress(got) == gzip.decompress(want)
    assert got == want


def test_device_trace_on_a_silent_card_answers_503(monkeypatch):
    """A capture that asked for CUDA activity and recorded none names the
    reason in a 503; no host-only trace is served in its place."""
    def silent(seconds, device=None):
        raise profiling.DeviceTraceUnavailable(
            "torch.profiler recorded no device activity on cuda:0")
    monkeypatch.setattr(profiling, "capture_device_trace", silent)
    api = HTTPApi(config_from_dict({}), address="127.0.0.1:0")
    api.start()
    try:
        status, body = _get(api, "/debug/profile/device?seconds=0.1")
        assert status == 503
        assert b"no device activity" in body
    finally:
        api.stop()


def test_profile_server_serves_the_capture():
    server = profiling.start_profile_server(0, "cpu")
    assert server is not None
    try:
        status, body = _get(server.address, "/?seconds=0.1")
        assert status == 200
        zf = assert_readable_zip(body)
        assert json.loads(zf.read("summary.json"))["device"] == "cpu"
    finally:
        server.stop()


def test_one_device_trace_at_a_time():
    assert profiling._device_trace_lock.acquire(blocking=False)
    try:
        with pytest.raises(RuntimeError, match="already in progress"):
            profiling.capture_device_trace(0.05, "cpu")
    finally:
        profiling._device_trace_lock.release()
