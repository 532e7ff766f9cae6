"""Profiling surface (port of veneur_tpu/core/profiling.py): the
pprof-equivalent for a GPU-hosted pipeline.

The reference always mounts Go pprof (reference http.go:53-63) and starts
a CPU profile when `enable_profiling` is set (reference
server.go:1382-1390). Python has no goroutine-style sampling profiler in
the stdlib, so this module provides (everything above the device trace is
the JAX package's code, unchanged):

  * StackSampler — a ~100 Hz all-threads stack sampler (the pprof CPU
    profile analog): aggregates `sys._current_frames()` into flat and
    cumulative hit counts per call site, reported as a text profile.
  * encode_pprof + sampler_to_pprof / heap_pprof / threads_pprof — real
    pprof wire format (hand-encoded profile.proto) for CPU, tracemalloc
    heap, and live-thread profiles; `go tool pprof` and speedscope read
    them directly.
  * the span recorder (`arm` / `record` / `disarm`) — the port's own
    spans (ingest, the tables' applies and copies, the flush's phases,
    the sinks' encode, gzip and POST, the K1/K2 launches), recorded on
    time.perf_counter only while a capture is armed; disarmed, a span
    site costs one flag test.
  * capture_device_trace — a bounded `torch.profiler.profile` session
    (CPU activity, and CUDA activity when the server's device is a
    card) whose Chrome trace is returned zipped (open it in Perfetto or
    chrome://tracing to see the kernels, copies and host ops), with the
    recorder's spans on a `veneur host spans` track beside them. A CUDA
    capture launches one probe kernel inside its window; when the trace
    holds no device event at all the host's CUPTI tracing gave nothing,
    and the capture raises DeviceTraceUnavailable naming that reason
    rather than return a host-only trace.
  * start_profile_server — torch has no counterpart of the JAX
    package's `jax.profiler.start_server` gRPC endpoint, so the port
    serves the same device-trace capture over HTTP on that port
    (`GET /?seconds=N` -> the zip), stopped with its server.

Wired to config `enable_profiling` (continuous sampler from startup) and
`profile_server_port`, and to the HTTP endpoints /debug/pprof/{profile,
heap,goroutine}, /debug/profile/cpu, and /debug/profile/device
(core.httpapi).
"""

from __future__ import annotations

import collections
import io
import logging
import os
import shutil
import socket
import sys
import tempfile
import threading
import time
import zipfile
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("veneur_tpu_torch.profiling")


class StackSampler:
    """Samples every thread's Python stack at `hz` and aggregates call
    sites. Flat hits = frames executing when sampled (self time);
    cumulative hits = frames anywhere on a sampled stack."""

    MAX_STACK_DEPTH = 64

    def __init__(self, hz: float = 100.0, collect_stacks: bool = False):
        self.hz = hz
        self._flat: collections.Counter = collections.Counter()
        self._cum: collections.Counter = collections.Counter()
        # full leaf-to-root stacks -> hits, for the pprof export. Only
        # request-scoped samplers collect these: leaf sites key on
        # f_lineno, so a continuous sampler would mint unbounded unique
        # stack tuples over a long-running server's lifetime
        self.collect_stacks = collect_stacks
        self._stacks: collections.Counter = collections.Counter()
        self._samples = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_at = 0.0

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._started_at = time.time()
        self._thread = threading.Thread(
            target=self._run, name="stack-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None

    # -- sampling ---------------------------------------------------------

    def _run(self) -> None:
        period = 1.0 / self.hz
        me = threading.get_ident()
        while not self._stop.wait(period):
            self._sample_once(me)

    def _sample_once(self, skip_ident: int) -> None:
        frames = sys._current_frames()
        with self._lock:
            self._samples += 1
            for ident, frame in frames.items():
                if ident == skip_ident:
                    continue
                seen = set()
                top = True
                stack = []
                while frame is not None:
                    code = frame.f_code
                    site = (code.co_filename, code.co_name,
                            frame.f_lineno if top else code.co_firstlineno)
                    if top:
                        self._flat[site] += 1
                        top = False
                    if site not in seen:
                        self._cum[site] += 1
                        seen.add(site)
                    if (self.collect_stacks
                            and len(stack) < self.MAX_STACK_DEPTH):
                        stack.append(site)
                    frame = frame.f_back
                if self.collect_stacks:
                    self._stacks[tuple(stack)] += 1

    # -- reporting --------------------------------------------------------

    def snapshot(self) -> Tuple[int, List, List]:
        with self._lock:
            return (self._samples,
                    self._flat.most_common(),
                    self._cum.most_common())

    def reset(self) -> None:
        with self._lock:
            self._flat.clear()
            self._cum.clear()
            self._stacks.clear()
            self._samples = 0
            self._started_at = time.time()

    def report(self, top: int = 40) -> str:
        """pprof-style text profile: flat% then cum% per call site."""
        samples, flat, cum = self.snapshot()
        lines = [
            f"cpu profile: {samples} samples "
            f"({time.time() - self._started_at:.1f}s at {self.hz:.0f} Hz)",
            "",
            f"{'flat%':>7} {'hits':>8}  site (self time)",
        ]
        for site, hits in flat[:top]:
            pct = 100.0 * hits / max(1, samples)
            lines.append(f"{pct:6.1f}% {hits:8d}  "
                         f"{_short(site[0])}:{site[2]} {site[1]}")
        lines += ["", f"{'cum%':>7} {'hits':>8}  site (cumulative)"]
        for site, hits in cum[:top]:
            pct = 100.0 * hits / max(1, samples)
            lines.append(f"{pct:6.1f}% {hits:8d}  "
                         f"{_short(site[0])}:{site[2]} {site[1]}")
        return "\n".join(lines) + "\n"


def _short(path: str) -> str:
    parts = path.split(os.sep)
    return os.sep.join(parts[-3:]) if len(parts) > 3 else path


def sample_for(seconds: float, hz: float = 100.0, top: int = 40) -> str:
    """One-shot profile: sample for `seconds`, return the text report
    (the request-scoped mode when no continuous sampler is running)."""
    sampler = StackSampler(hz=hz)
    sampler.start()
    time.sleep(max(0.01, seconds))
    sampler.stop()
    return sampler.report(top=top)


# -- pprof wire format ------------------------------------------------------
# Hand-encoded https://github.com/google/pprof profile.proto (the schema
# is small and stable), so `go tool pprof` / speedscope / pyroscope read
# our CPU profiles directly — the reference serves real pprof at
# /debug/pprof/profile (http.go:53-63).

def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _field_bytes(tag: int, payload: bytes) -> bytes:
    return _varint((tag << 3) | 2) + _varint(len(payload)) + payload


def _field_varint(tag: int, value: int) -> bytes:
    return _varint(tag << 3) + _varint(value)


def _packed(tag: int, values) -> bytes:
    body = b"".join(_varint(v) for v in values)
    return _field_bytes(tag, body)


def encode_pprof(stacks, sample_types, period_type, period: int,
                 started: float) -> bytes:
    """Encode aggregated stacks as a gzipped pprof Profile.

    stacks: {leaf-first tuple of (filename, name, line): [values...]}
    with one value per entry in sample_types ([(type, unit), ...]);
    period_type is the (type, unit) of `period`. One Location+Function
    is emitted per unique call site."""
    import gzip

    strings: Dict[str, int] = {"": 0}

    def sid(s: str) -> int:
        i = strings.get(s)
        if i is None:
            i = strings[s] = len(strings)
        return i

    func_ids: Dict[Tuple[str, str], int] = {}
    functions: List[bytes] = []
    loc_ids: Dict[Tuple[str, str, int], int] = {}
    locations: List[bytes] = []

    def loc_id(site: Tuple[str, str, int]) -> int:
        i = loc_ids.get(site)
        if i is not None:
            return i
        filename, name, line = site
        fkey = (filename, name)
        fid = func_ids.get(fkey)
        if fid is None:
            fid = func_ids[fkey] = len(functions) + 1
            functions.append(
                _field_varint(1, fid)
                + _field_varint(2, sid(name))
                + _field_varint(3, sid(name))
                + _field_varint(4, sid(filename)))
        i = loc_ids[site] = len(locations) + 1
        line_msg = _field_varint(1, fid) + _field_varint(2, line)
        locations.append(
            _field_varint(1, i) + _field_bytes(4, line_msg))
        return i

    samples: List[bytes] = []
    for stack, values in stacks.items():
        ids = [loc_id(site) for site in stack]  # already leaf-first
        samples.append(_packed(1, ids) + _packed(2, values))

    def value_type(type_s: str, unit_s: str) -> bytes:
        return (_field_varint(1, sid(type_s))
                + _field_varint(2, sid(unit_s)))

    out = bytearray()
    for type_s, unit_s in sample_types:
        out += _field_bytes(1, value_type(type_s, unit_s))
    for s in samples:
        out += _field_bytes(2, s)
    for loc in locations:
        out += _field_bytes(4, loc)
    for fn in functions:
        out += _field_bytes(5, fn)
    for s in sorted(strings, key=strings.get):
        out += _field_bytes(6, s.encode())
    out += _field_varint(9, int(started * 1e9))
    out += _field_varint(10, int((time.time() - started) * 1e9))
    out += _field_bytes(11, value_type(*period_type))
    out += _field_varint(12, period)
    return gzip.compress(bytes(out))


def sampler_to_pprof(sampler: StackSampler) -> bytes:
    """CPU profile: samples/count + cpu/nanoseconds (the shape Go's CPU
    profile uses)."""
    with sampler._lock:
        raw = dict(sampler._stacks)
        started = sampler._started_at
    period_ns = int(1e9 / sampler.hz)
    stacks = {stack: [hits, hits * period_ns] for stack, hits in raw.items()}
    return encode_pprof(stacks, [("samples", "count"),
                                 ("cpu", "nanoseconds")],
                        ("cpu", "nanoseconds"), period_ns, started)


def threads_pprof() -> bytes:
    """All live thread stacks as a pprof profile (the goroutine-profile
    analog: one sample per thread, value 1)."""
    stacks: Dict[tuple, list] = {}
    for frame in sys._current_frames().values():
        stack = []
        while frame is not None and len(stack) < StackSampler.MAX_STACK_DEPTH:
            code = frame.f_code
            stack.append((code.co_filename, code.co_name, frame.f_lineno))
            frame = frame.f_back
        key = tuple(stack)
        prev = stacks.get(key)
        if prev is None:
            stacks[key] = [1]
        else:
            prev[0] += 1
    return encode_pprof(stacks, [("threads", "count")],
                        ("threads", "count"), 1, time.time())


def empty_pprof(kind: str, unit: str = "count") -> bytes:
    """A valid zero-sample pprof profile. Served at /debug/pprof/block
    and /mutex: the Go runtime's contention profilers have no CPython
    analog (no runtime hook records lock-wait stacks), and an empty
    profile keeps `go tool pprof`-style consumers working instead of
    breaking scrapers with a 404 (reference http.go mounts every pprof
    route unconditionally)."""
    return encode_pprof({}, [(kind, unit)], (kind, unit), 1, time.time())


def threadcreate_pprof() -> bytes:
    """/debug/pprof/threadcreate analog: CPython doesn't record which
    stack created each thread, so this reports one synthetic sample
    carrying the live-thread count (the headline number Go's profile is
    scraped for)."""
    site = (("<unavailable>", "threading.create (sites not recorded)", 0),)
    return encode_pprof({site: [threading.active_count()]},
                        [("threadcreate", "count")],
                        ("threadcreate", "count"), 1, time.time())


_heap_traced_since = [0.0]
_heap_last_armed = [0.0]
_heap_lock = threading.Lock()
# minimum spacing between request-scoped tracemalloc armings: hammering
# the unauthenticated endpoint must not keep 25-frame tracing (the
# steady-state ingest overhead the request-scoped design removes)
# effectively always-on, nor serialize HTTP threads behind back-to-back
# half-second holds
HEAP_ARM_MIN_INTERVAL_S = 10.0


class HeapProfileThrottled(RuntimeError):
    """Raised when a request-scoped arming is asked for too soon after
    the previous one (HTTP layer maps it to 429)."""


def heap_pprof(limit: int = 10_000, keep_tracing: bool = False) -> bytes:
    """Heap profile at /debug/pprof/heap: a tracemalloc snapshot encoded
    as pprof with objects/count + space/bytes sample types. CPython can't
    reconstruct allocations made before tracing began, so a request with
    tracing off arms it for the duration of the request only — 25-frame
    tracemalloc costs real steady-state CPU on the ingest hot path, and a
    single unauthenticated GET must not durably slow the server (the Go
    reference's heap profile is near-free). keep_tracing=True (the
    enable_profiling config) leaves it armed so later requests see
    everything allocated since."""
    import tracemalloc

    # serialized: without the lock, one request's request-scoped stop()
    # could land between another's is_tracing() check and take_snapshot()
    with _heap_lock:
        armed_here = False
        if not tracemalloc.is_tracing():
            now = time.time()
            if not keep_tracing and \
                    now - _heap_last_armed[0] < HEAP_ARM_MIN_INTERVAL_S:
                raise HeapProfileThrottled(
                    f"heap profile re-armed too soon; retry in "
                    f"{HEAP_ARM_MIN_INTERVAL_S - (now - _heap_last_armed[0]):.0f}s")
            tracemalloc.start(25)
            armed_here = True
            _heap_last_armed[0] = now
            _heap_traced_since[0] = now
            # give the arena a moment to accumulate request-scoped
            # truth: with tracing armed only for this request, an
            # instant snapshot would be near-empty
            time.sleep(0.5)
        try:
            snap = tracemalloc.take_snapshot()
        finally:
            if armed_here and not keep_tracing:
                tracemalloc.stop()
                _heap_traced_since[0] = 0.0
    stats = sorted(snap.statistics("traceback"),
                   key=lambda s: s.size, reverse=True)[:limit]
    stacks = {}
    for st in stats:
        stack = tuple(
            (fr.filename, os.path.basename(fr.filename), fr.lineno)
            for fr in reversed(st.traceback))  # leaf-first
        prev = stacks.get(stack)
        if prev is None:
            stacks[stack] = [st.count, st.size]
        else:
            prev[0] += st.count
            prev[1] += st.size
    body = encode_pprof(stacks, [("objects", "count"), ("space", "bytes")],
                        ("space", "bytes"), 1,
                        _heap_traced_since[0] or time.time())
    _heap_last_profile[0] = body
    return body


_heap_last_profile = [b""]


def heap_pprof_or_cached(keep_tracing: bool = False) -> Tuple[bytes, bool]:
    """(profile, fresh) for the /heap and /allocs routes. Go serves both
    freely; here a back-to-back scrape of the pair would trip the
    arming throttle on the second request, so inside the throttle
    window the previous capture is served instead (its embedded
    time_nanos dates it). Raises HeapProfileThrottled only when there
    is no capture to fall back on."""
    try:
        return heap_pprof(keep_tracing=keep_tracing), True
    except HeapProfileThrottled:
        if _heap_last_profile[0]:
            return _heap_last_profile[0], False
        raise


_cpu_profile_lock = threading.Lock()


def pprof_for(seconds: float, hz: float = 100.0) -> bytes:
    """One-shot pprof-format CPU profile (the /debug/pprof/profile
    contract: block for `seconds`, then return the gzipped proto).

    One capture at a time, matching Go pprof: concurrent requests would
    each spawn a 100 Hz sys._current_frames() sampler and compound
    whole-process GIL overhead. Raises RuntimeError when busy (the HTTP
    layer maps it to a 503)."""
    if not _cpu_profile_lock.acquire(blocking=False):
        raise RuntimeError("a CPU profile capture is already in progress")
    try:
        sampler = StackSampler(hz=hz, collect_stacks=True)
        sampler.start()
        time.sleep(max(0.01, seconds))
        sampler.stop()
        return sampler_to_pprof(sampler)
    finally:
        _cpu_profile_lock.release()


# -- the span recorder -------------------------------------------------------
# Spans of the program's own work: ingest batches and their parse, slow
# path and appends, the tables' applies and copies, the flush's phases,
# the sinks' encode, gzip and POST, and the K1, K2 and K3 launches, the
# llhist flush's compaction and assembly. A span site
# tests `armed` and, while it is False, does nothing more: no clock read,
# no allocation. While a capture is armed it reads time.perf_counter() at
# both ends (or reuses readings its code takes anyway) and calls
# `record`. A record is a tuple (name, thread ident, start, end, args):
# start and end in perf_counter seconds, args None or a small dict
# (bytes, lines, samples, launches, a shape, thread CPU seconds). One
# capture at a time: `arm(capacity)` ... `disarm()`.

armed = False


class _SpanBuffer:
    """One capture's records, at most `capacity`; the rest are counted
    as dropped. `records` is None once the capture is disarmed."""

    __slots__ = ("records", "capacity", "dropped", "lock")

    def __init__(self, capacity: int):
        self.records: Optional[List[tuple]] = []
        self.capacity = int(capacity)
        self.dropped = 0
        self.lock = threading.Lock()


_capture: Optional[_SpanBuffer] = None
_arm_lock = threading.Lock()


def arm(capacity: int) -> None:
    """Start recording spans into a buffer of `capacity` records. Raises
    RuntimeError while another capture is armed."""
    global armed, _capture
    with _arm_lock:
        if _capture is not None:
            raise RuntimeError("a span capture is already armed")
        _capture = _SpanBuffer(capacity)
        armed = True


def disarm() -> Tuple[List[tuple], int]:
    """Stop recording; returns (records, dropped) of the capture, in the
    order they were recorded (([], 0) when none was armed)."""
    global armed, _capture
    with _arm_lock:
        buf, _capture = _capture, None
        armed = False
    if buf is None:
        return [], 0
    with buf.lock:
        records, buf.records = buf.records, None
        return records, buf.dropped


def record(name: str, start: float, end: float,
           args: Optional[dict] = None) -> None:
    """One span of the calling thread, when a capture is armed (a site
    that saw `armed` before a disarm records nothing after it)."""
    buf = _capture
    if buf is None:
        return
    item = (name, threading.get_ident(), start, end, args)
    with buf.lock:
        if buf.records is None:
            return
        if len(buf.records) < buf.capacity:
            buf.records.append(item)
        else:
            buf.dropped += 1


# the span capacity of a device-trace capture: ~20 spans an ingest batch
# at a few hundred batches a second, for up to the 120 s a capture takes
DEVICE_TRACE_SPAN_CAPACITY = 2_000_000
# the capture's marker: a range whose probe places the host spans on the
# profiler's clock
PROBE_RANGE = "veneur.span_clock_probe"
HOST_SPAN_TRACK = "veneur host spans"

_device_trace_lock = threading.Lock()

# trace event categories of the card's own activity (CUPTI records):
# kernels, copies and sets
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTraceUnavailable(RuntimeError):
    """A device trace was asked of a card, but the profiler recorded no
    device activity (the HTTP layer maps it to a 503 naming the
    reason)."""


def device_events(trace: dict) -> List[dict]:
    """The Chrome trace's device events (kernels, copies, sets)."""
    return [e for e in trace.get("traceEvents", ())
            if e.get("cat") in DEVICE_EVENT_CATS]


def _clock_probe(dev) -> Tuple[float, float]:
    """The capture's marker: a range named PROBE_RANGE around one probe
    kernel's launch on `dev` (around nothing on the CPU), bracketed by
    host readings with the card synchronised; returns them."""
    import torch
    probe = None
    if dev is not None:
        probe = torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    t_a = time.perf_counter()
    with torch.profiler.record_function(PROBE_RANGE):
        if probe is not None:
            probe.add_(1.0)
    if dev is not None:
        torch.cuda.synchronize(dev)
    return t_a, time.perf_counter()


def _probe_offset(events: List[dict], host_mid: float
                  ) -> Tuple[Optional[float], Optional[str]]:
    """Microseconds to add to a perf_counter reading, times 1e6, to place
    it on the trace's clock, and what placed it: the probe kernel's
    device start (found through its launch's correlation id inside the
    probe range) at the midpoint of the host readings around it, as
    portbench/devtrace.py places its marker; without a kernel, the probe
    range's own midpoint. (None, None) when the trace lacks the range."""
    ranges = [e for e in events if e.get("name") == PROBE_RANGE
              and e.get("cat") == "user_annotation"]
    if not ranges:
        return None, None
    rng = ranges[0]
    lo, hi = rng["ts"], rng["ts"] + rng.get("dur", 0)
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") == "cuda_runtime" and e.get("tid") == rng["tid"]
            and lo <= e.get("ts", lo - 1) <= hi
            and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in corr]
    if kernels:
        return kernels[0]["ts"] - host_mid * 1e6, "probe kernel"
    return (lo + hi) / 2 - host_mid * 1e6, "probe range"


def _host_span_events(spans: List[tuple], offset_us: float,
                     pid: int) -> List[dict]:
    """Chrome trace events of recorded spans: one complete event each on
    the HOST_SPAN_TRACK process `pid`, a track per thread, placed on the
    trace's clock by `offset_us` (_probe_offset)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": HOST_SPAN_TRACK}}]
    tids: Dict[int, int] = {}
    for name, ident, start, end, args in spans:
        tid = tids.get(ident)
        if tid is None:
            tid = tids[ident] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {
                            "name": names.get(ident, f"thread {ident}")}})
        ev = {"ph": "X", "cat": "host_span", "name": name, "pid": pid,
              "tid": tid, "ts": start * 1e6 + offset_us,
              "dur": (end - start) * 1e6}
        if args:
            ev["args"] = args
        out.append(ev)
    return out


def capture_device_trace(seconds: float, device=None) -> bytes:
    """Run `torch.profiler.profile` for `seconds` and return a zip of its
    Chrome trace (`trace.json`) and a summary (`summary.json`: the
    activities traced, the device, the count of device events, the host
    spans). `device` is the server's torch device: a CUDA device adds
    CUDA activity, and a probe kernel launched inside the window proves
    the tracing works; a CUDA capture that recorded no device event
    raises DeviceTraceUnavailable. The span recorder is armed for the
    window: its spans join the trace on a `veneur host spans` track,
    placed on the profiler's clock by the probe (_probe_offset), each
    beside the kernels it launched. One capture at a time: a second, or
    one while another span capture is armed, raises RuntimeError (503
    at the HTTP layer)."""
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not _device_trace_lock.acquire(blocking=False):
        raise RuntimeError("a device trace capture is already in progress")
    try:
        dev = torch.device(device) if device is not None else None
        on_card = dev is not None and dev.type == "cuda"
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        tmp = tempfile.mkdtemp(prefix="veneur-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            with profile(activities=activities) as prof:
                arm(DEVICE_TRACE_SPAN_CAPACITY)
                try:
                    t_a, t_b = _clock_probe(dev if on_card else None)
                    time.sleep(max(0.05, seconds))
                    if on_card:
                        torch.cuda.synchronize(dev)
                finally:
                    spans, dropped = disarm()
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
            events = trace.setdefault("traceEvents", [])
            n_device = len(device_events(trace))
            if on_card and n_device == 0:
                raise DeviceTraceUnavailable(
                    "torch.profiler recorded no device activity on "
                    f"{dev} (not even its probe kernel): this host's "
                    "CUPTI activity tracing returned no CUDA events")
            offset, placed_by = _probe_offset(events, (t_a + t_b) / 2)
            if offset is not None:
                pid = 1 + max((e["pid"] for e in events
                               if isinstance(e.get("pid"), int)), default=0)
                events.extend(_host_span_events(spans, offset, pid))
            summary = {
                "activities": [a.name for a in activities],
                "device": str(dev) if dev is not None else None,
                "seconds": seconds, "device_events": n_device,
                "events": len(events),
                "host_spans": len(spans) if offset is not None else 0,
                "host_spans_dropped": dropped,
                "host_span_clock": placed_by,
            }
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
                zf.writestr("trace.json", json.dumps(trace))
                zf.writestr("summary.json", json.dumps(summary))
            return buf.getvalue()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    finally:
        _device_trace_lock.release()


class ProfileServer:
    """The `profile_server_port` endpoint: `GET /?seconds=N` answers a
    device-trace capture's zip (N defaults to 2, at most 120), 503 while
    another capture runs or when the card gave no device events. Binds
    with SO_REUSEPORT, as the HTTP API does, so a SIGUSR2 replacement
    binds beside it."""

    def __init__(self, port: int, device=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        owner = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802
                try:
                    vals = parse_qs(urlparse(self.path).query).get(
                        "seconds")
                    seconds = min(max(float(vals[0]) if vals else 2.0,
                                      0.0), 120.0)
                except ValueError:
                    seconds = 2.0
                try:
                    body = capture_device_trace(seconds, owner.device)
                    status, ctype = 200, "application/zip"
                except RuntimeError as e:
                    body, status = f"{e}\n".encode(), 503
                    ctype = "text/plain"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        class Reusable(ThreadingHTTPServer):
            daemon_threads = True

            def server_bind(self):
                if hasattr(socket, "SO_REUSEPORT"):
                    self.socket.setsockopt(socket.SOL_SOCKET,
                                           socket.SO_REUSEPORT, 1)
                super().server_bind()

        self.device = device
        # every interface, as jax.profiler's server listens
        self._httpd = Reusable(("0.0.0.0", int(port)), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="profile-server",
            daemon=True)
        self._thread.start()

    @property
    def address(self):
        return self._httpd.server_address

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def start_profile_server(port: int, device=None) -> Optional[ProfileServer]:
    """Serve device-trace captures on `port`; None (logged) when the port
    cannot be bound."""
    try:
        server = ProfileServer(port, device)
    except OSError:
        logger.exception("could not start the profile server on port %d",
                         port)
        return None
    logger.info("profile server on port %d", server.address[1])
    return server
