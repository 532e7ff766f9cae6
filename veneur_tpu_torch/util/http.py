"""HTTP POST helpers shared by HTTP sinks.

Behavioral parity with reference http/http.go (282 LoC): JSON/protobuf
POST with optional gzip/deflate compression, timeout, and a tiny
pure-Python snappy *block-format* encoder for Prometheus remote-write
(reference sinks/cortex/cortex.go uses github.com/golang/snappy).

Everything here is stdlib-only: urllib for transport so sinks work in the
hermetic test environment without `requests`. (A copy of
veneur_tpu/util/http.py, with its `http_post` fault-injection seam in
`post`, util/chaos.py.)
"""

from __future__ import annotations

import gzip
import json
import time
import urllib.error
import urllib.request
import zlib
from typing import Any, Dict, List, Optional, Tuple

from veneur_tpu_torch.core import profiling
from veneur_tpu_torch.util import chaos as chaos_mod
from veneur_tpu_torch.util.chaos import ChaosError

# vendor responses worth another attempt: throttling (429) and transient
# unavailability (503); everything else (auth, bad payload, 5xx bugs) is
# structural and retrying it only doubles the damage
RETRYABLE_STATUSES = frozenset((429, 503))


class HTTPError(Exception):
    def __init__(self, status: int, body: bytes = b"",
                 retry_after: Optional[float] = None):
        super().__init__(f"HTTP {status}: {body[:200]!r}")
        self.status = status
        self.body = body
        # parsed Retry-After (seconds), when the server sent one
        self.retry_after = retry_after

    @property
    def retryable(self) -> bool:
        return self.status in RETRYABLE_STATUSES


def _parse_retry_after(value: Optional[str]) -> Optional[float]:
    """Retry-After per RFC 9110: delta-seconds or an HTTP-date."""
    if not value:
        return None
    value = value.strip()
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        from email.utils import parsedate_to_datetime
        when = parsedate_to_datetime(value)
        return max(0.0, when.timestamp() - time.time())
    except (TypeError, ValueError):
        return None


def snappy_encode(data: bytes) -> bytes:
    """Encode `data` in snappy block format using only literal elements.

    The snappy format permits a stream consisting entirely of literals
    (no back-references); any conformant decoder accepts it. Layout:
    uvarint(len(data)) then literal chunks. A literal tag byte has low
    bits 00 and encodes lengths <=60 inline; longer literals store the
    length in 1-4 little-endian bytes selected by tag values 60-63.
    """
    out = bytearray()
    # preamble: uncompressed length as uvarint
    n = len(data)
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    pos = 0
    total = len(data)
    while pos < total:
        chunk = data[pos:pos + 65536]
        ln = len(chunk) - 1
        if ln < 60:
            out.append(ln << 2)
        elif ln < (1 << 8):
            out.append(60 << 2)
            out.append(ln)
        else:  # chunk capped at 65536 so two bytes always suffice
            out.append(61 << 2)
            out += ln.to_bytes(2, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)


def snappy_decode(data: bytes) -> bytes:
    """Decode snappy block format (full format: literals + copies).

    Used only by tests and the cortex test fake; kept complete so any
    real snappy writer's output round-trips too.
    """
    # uvarint preamble
    ulen = 0
    shift = 0
    pos = 0
    while True:
        b = data[pos]
        pos += 1
        ulen |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        elem_type = tag & 0x03
        if elem_type == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                ln = int.from_bytes(data[pos:pos + extra], "little")
                pos += extra
            ln += 1
            out += data[pos:pos + ln]
            pos += ln
        elif elem_type == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
            _copy(out, offset, ln)
        elif elem_type == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
            _copy(out, offset, ln)
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
            _copy(out, offset, ln)
    if len(out) != ulen:
        raise ValueError(f"snappy: length mismatch {len(out)} != {ulen}")
    return bytes(out)


def _copy(out: bytearray, offset: int, length: int) -> None:
    if offset <= 0 or offset > len(out):
        raise ValueError("snappy: bad copy offset")
    for _ in range(length):  # may overlap; copy byte-wise
        out.append(out[-offset])


def post(url: str, body: bytes, *,
         content_type: str = "application/json",
         headers: Optional[Dict[str, str]] = None,
         compress: Optional[str] = None,
         timeout: float = 10.0, method: str = "POST",
         proxy_url: str = "",
         gzip_seconds: Optional[List[float]] = None) -> Tuple[int, bytes]:
    """Send `body` (POST by default), optionally compressed
    ("gzip"/"deflate"), returning (status, response body). Raises
    HTTPError on non-2xx. proxy_url routes the request through an
    explicit HTTP(S) proxy, overriding environment proxies.
    `gzip_seconds`, when given, receives the gzip's seconds (appended,
    so threads may share one list). While the span recorder
    (core/profiling.py) is armed, the gzip is the span `sink.gzip`
    (bytes in and out) and the request, from here to its answer,
    `sink.post` (bytes sent)."""
    armed = profiling.armed
    hdrs = {"Content-Type": content_type}
    if compress == "gzip":
        # one pair of readings serves the counter and the span
        t0, n_in = time.perf_counter(), len(body)
        body = gzip.compress(body, compresslevel=6)
        t1 = time.perf_counter()
        if gzip_seconds is not None:
            gzip_seconds.append(t1 - t0)
        if armed:
            profiling.record("sink.gzip", t0, t1, {
                "bytes_in": n_in, "bytes_out": len(body)})
        hdrs["Content-Encoding"] = "gzip"
    elif compress == "deflate":
        body = zlib.compress(body, 6)
        hdrs["Content-Encoding"] = "deflate"
    if headers:
        hdrs.update(headers)
    req = urllib.request.Request(url, data=body, headers=hdrs,
                                 method=method)
    opener = urllib.request.urlopen
    if proxy_url:
        opener = urllib.request.build_opener(urllib.request.ProxyHandler(
            {"http": proxy_url, "https": proxy_url})).open
    if armed:
        t_post = time.perf_counter()
    # fault-injection seam: no-op unless a chaos plan is installed
    chaos_mod.inject("http_post")
    try:
        with opener(req, timeout=timeout) as resp:
            out = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        raise HTTPError(e.code, e.read(),
                        retry_after=_parse_retry_after(
                            e.headers.get("Retry-After"))) from e
    if armed:
        profiling.record("sink.post", t_post, time.perf_counter(),
                         {"bytes": len(body)})
    return out


def post_with_retry(url: str, body: bytes, *,
                    retry=None, budget: float = 10.0,
                    **kwargs) -> Tuple[int, bytes]:
    """`post` with the shared backoff policy (util/resilience.py):
    retries 429/503 (honoring Retry-After), connection errors, and
    injected chaos, never spending more than `budget` seconds total —
    sinks call this from their per-sink flush thread, whose own bound is
    one flush interval."""
    from veneur_tpu_torch.util.resilience import RetryPolicy
    retry = retry or RetryPolicy()
    deadline = time.monotonic() + budget
    delays = retry.delays(budget)
    while True:
        try:
            return post(url, body, **kwargs)
        except (HTTPError, urllib.error.URLError, ChaosError) as e:
            retryable = (isinstance(e, (urllib.error.URLError, ChaosError))
                         or getattr(e, "retryable", False))
            delay = next(delays, None) if retryable else None
            if delay is None:
                raise
            # a server-provided Retry-After overrides (extends) backoff,
            # still inside the budget
            retry_after = getattr(e, "retry_after", None)
            if retry_after:
                delay = max(delay, retry_after)
            if time.monotonic() + delay >= deadline:
                raise
            time.sleep(delay)


def post_json(url: str, obj: Any, *, headers: Optional[Dict[str, str]] = None,
              compress: Optional[str] = "gzip",
              timeout: float = 10.0) -> Tuple[int, bytes]:
    return post(url, json.dumps(obj, separators=(",", ":")).encode(),
                headers=headers, compress=compress, timeout=timeout)


def put_json(url: str, obj: Any, *,
             headers: Optional[Dict[str, str]] = None,
             timeout: float = 10.0) -> Tuple[int, bytes]:
    """Uncompressed JSON PUT (the Datadog traces endpoint rejects
    compressed bodies, reference datadog.go:638-643)."""
    return post(url, json.dumps(obj, separators=(",", ":")).encode(),
                headers=headers, compress=None, timeout=timeout,
                method="PUT")


def get(url: str, *, headers: Optional[Dict[str, str]] = None,
        timeout: float = 10.0, ssl_context=None) -> Tuple[int, bytes]:
    req = urllib.request.Request(url, headers=headers or {}, method="GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout,
                                    context=ssl_context) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        raise HTTPError(e.code, e.read()) from e
