"""Native (C++) host code of the port: the batch DogStatsD parser and the
recvmmsg ingest pump (the ctypes binding of veneur_tpu/native, over a
copy of its dogstatsd.cc).

The shared library compiles from `dogstatsd.cc` with the system g++ at
first use, into `build/native/` beside the package, named by a hash of
the source and the flags. A build writes a temporary file and moves it
into place, so parallel processes never load a half-written library.

A missing g++, a failed compile or a failed load raises with g++'s
output: there is no switch that turns the native code off and no silent
fall back. The numpy columnar decoder (core/batchdecode.py) is chosen
explicitly, by `tpu.disable_native_parser: true`.

What the port uses: the intern table (`Engine`), the batch parser
(`NativeParser`) and the pump (`Pump`) on the ingest side; the MetricList
import parser (`parse_metric_list`, `decode_import_key`) and the digest
encoder and metric wrapper (`vnt_digest_encode`, `vnt_metric_wrap`,
called by forward/convert.py) on the forward tier. The SSF, route,
row-unregister (idle-row reclamation), per-socket reader and
load-generator entry points of the library wait for their slices.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "dogstatsd.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++20", "-shared", "-fPIC")
_BUILD_TIMEOUT_S = 300

_lib = None
_lib_lock = threading.Lock()

# family codes, mirroring dogstatsd.cc
FAM_COUNTER = 0
FAM_GAUGE = 1
FAM_HISTO = 2
FAM_SET = 3
FAM_LLHIST = 4


class ChunkDesc(ctypes.Structure):
    """Mirror of dogstatsd.cc ChunkDesc: one sealed pump chunk's array
    pointers and counts."""

    _fields_ = [
        ("c_rows", ctypes.c_void_p), ("c_vals", ctypes.c_void_p),
        ("c_rates", ctypes.c_void_p), ("c_n", ctypes.c_int64),
        ("g_rows", ctypes.c_void_p), ("g_vals", ctypes.c_void_p),
        ("g_lines", ctypes.c_void_p), ("g_n", ctypes.c_int64),
        ("h_rows", ctypes.c_void_p), ("h_vals", ctypes.c_void_p),
        ("h_wts", ctypes.c_void_p), ("h_n", ctypes.c_int64),
        ("s_rows", ctypes.c_void_p), ("s_idx", ctypes.c_void_p),
        ("s_rho", ctypes.c_void_p), ("s_n", ctypes.c_int64),
        ("l_rows", ctypes.c_void_p), ("l_bins", ctypes.c_void_p),
        ("l_wts", ctypes.c_void_p), ("l_n", ctypes.c_int64),
        ("l_clamped", ctypes.c_int64),
        ("arena", ctypes.c_void_p), ("unk_off", ctypes.c_void_p),
        ("unk_len", ctypes.c_void_p), ("unk_line", ctypes.c_void_p),
        ("unk_n", ctypes.c_int64),
        ("lines", ctypes.c_int64), ("samples", ctypes.c_int64),
        ("dgrams", ctypes.c_int64), ("dropped", ctypes.c_int64),
        ("reader", ctypes.c_int64), ("dwell_ms", ctypes.c_int64),
    ]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libvntdogstatsd-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises with g++'s output when g++ is missing or the compile fails."""
    path = library_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native parser "
                           "builds from veneur_tpu_torch/native/dogstatsd.cc "
                           "at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}."
                         f"{threading.get_ident()}.tmp.so")
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True,
                              timeout=_BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, path)  # atomic against a concurrent build
    finally:
        if tmp.exists():
            tmp.unlink()
    return path


def _declare(lib) -> None:
    i64, i32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)
    f32p, i64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
    lib.vnt_new.restype = ctypes.c_void_p
    lib.vnt_new.argtypes = []
    lib.vnt_free.restype = None
    lib.vnt_free.argtypes = [ctypes.c_void_p]
    lib.vnt_size.restype = i64
    lib.vnt_size.argtypes = [ctypes.c_void_p]
    lib.vnt_register.restype = None
    lib.vnt_register.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_double]
    lib.vnt_parse.restype = i64
    lib.vnt_parse.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64,
        i32p, f32p, f32p, i64, i64p,          # counters
        i32p, f32p, i32p, i64, i64p,          # gauges (+line index)
        i32p, f32p, f32p, i64, i64p,          # histos
        i32p, i32p, i32p, i64, i64p,          # sets
        i32p, i32p, i32p, i64, i64p, i64p,    # llhists (+clamped weight)
        i64p, i64p, i32p, i64, i64p,          # unknown lines (+line index)
        i64p,                                 # samples parsed
    ]
    lib.vnt_pump_new.restype = ctypes.c_void_p
    lib.vnt_pump_new.argtypes = [
        ctypes.c_void_p, i32p, ctypes.c_int32, ctypes.c_int32, i64, i64,
        i64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.vnt_pump_next.restype = ctypes.c_void_p
    lib.vnt_pump_next.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ChunkDesc)]
    lib.vnt_pump_release.restype = None
    lib.vnt_pump_release.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.vnt_pump_stalls.restype = i64
    lib.vnt_pump_stalls.argtypes = [ctypes.c_void_p]
    lib.vnt_pump_nreaders.restype = ctypes.c_int32
    lib.vnt_pump_nreaders.argtypes = [ctypes.c_void_p]
    lib.vnt_pump_signal_stop.restype = None
    lib.vnt_pump_signal_stop.argtypes = [ctypes.c_void_p]
    lib.vnt_pump_live.restype = ctypes.c_int32
    lib.vnt_pump_live.argtypes = [ctypes.c_void_p]
    lib.vnt_pump_lost_lines.restype = i64
    lib.vnt_pump_lost_lines.argtypes = [ctypes.c_void_p]
    lib.vnt_pump_ring_stats.restype = None
    lib.vnt_pump_ring_stats.argtypes = [
        ctypes.c_void_p, i64p, i64p, i64p, i64p]
    lib.vnt_pump_stop.restype = None
    lib.vnt_pump_stop.argtypes = [ctypes.c_void_p]
    lib.vnt_pump_free.restype = None
    lib.vnt_pump_free.argtypes = [ctypes.c_void_p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.vnt_import_count.restype = i64
    lib.vnt_import_count.argtypes = [ctypes.c_void_p, i64]
    lib.vnt_import_parse.restype = i64
    lib.vnt_import_parse.argtypes = [
        ctypes.c_void_p, i64, i64, ctypes.c_double,
        u8p, i64,
        i64p, i64p, f64p, i64, i64p,            # counters
        i64p, i64p, f64p, i64, i64p,            # gauges
        i64p, i64p, f32p, f32p, f64p, f64p, f64p, i64, i64p,  # histos
        i64p, i64p, i64p, i64p, i64, i64p,      # sets
    ]
    lib.vnt_digest_encode.restype = i64
    lib.vnt_digest_encode.argtypes = [
        f32p, f32p, i64, i64, f64p, f64p, f64p, ctypes.c_double,
        u8p, i64, i64p]
    lib.vnt_metric_wrap.restype = i64
    lib.vnt_metric_wrap.argtypes = [
        u8p, i64p, u8p, i64p, u8p, i64p, i64, u8p, i64, i64p]


def load():
    """The loaded ctypes library, built on first use (raises on any
    build or load failure)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


class ParseResult:
    """Output of one NativeParser.parse call; arrays are views trimmed to
    their filled lengths and valid until the parser's next parse call."""

    __slots__ = ("lines", "samples", "c_rows", "c_vals", "c_rates",
                 "g_rows", "g_vals", "g_lines", "h_rows", "h_vals", "h_wts",
                 "s_rows", "s_idx", "s_rho",
                 "l_rows", "l_bins", "l_wts", "l_clamped",
                 "unknown", "unknown_lines")

    def __init__(self):
        self.lines = 0
        self.samples = 0
        self.l_clamped = 0
        self.unknown = []
        self.unknown_lines = []


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class Engine:
    """Owns one C++ intern table, shareable by many NativeParsers and a
    Pump (the C table takes a shared lock for parse, exclusive for
    register)."""

    def __init__(self):
        self._lib = load()
        self.ptr = self._lib.vnt_new()

    def __del__(self):
        if getattr(self, "ptr", None):
            self._lib.vnt_free(self.ptr)
            self.ptr = None

    def size(self) -> int:
        return self._lib.vnt_size(self.ptr)

    def register(self, meta_key: bytes, family: int, row: int,
                 rate: float) -> None:
        self._lib.vnt_register(
            self.ptr, meta_key, len(meta_key), family, row, rate)


class NativeParser:
    """Reusable parse-output buffers over a (possibly shared) Engine.

    Thread safety: the C table is internally locked, but the output
    buffers here are not — callers either hold their own lock or use one
    NativeParser per thread (sharing the engine)."""

    def __init__(self, engine: "Engine | None" = None):
        self._lib = load()
        self.engine = engine if engine is not None else Engine()
        self._eng = self.engine.ptr
        self._cap = 0
        # c,g,h,s,unk,samples,llhist,llhist_clamped
        self._outs = [ctypes.c_int64() for _ in range(8)]

    def _ensure_capacity(self, cap: int) -> None:
        if cap <= self._cap:
            return
        cap = max(cap, 4096)
        self._c_rows = np.empty(cap, np.int32)
        self._c_vals = np.empty(cap, np.float32)
        self._c_rates = np.empty(cap, np.float32)
        self._g_rows = np.empty(cap, np.int32)
        self._g_vals = np.empty(cap, np.float32)
        self._g_lines = np.empty(cap, np.int32)
        self._h_rows = np.empty(cap, np.int32)
        self._h_vals = np.empty(cap, np.float32)
        self._h_wts = np.empty(cap, np.float32)
        self._s_rows = np.empty(cap, np.int32)
        self._s_idx = np.empty(cap, np.int32)
        self._s_rho = np.empty(cap, np.int32)
        self._l_rows = np.empty(cap, np.int32)
        self._l_bins = np.empty(cap, np.int32)
        self._l_wts = np.empty(cap, np.int32)
        self._unk_off = np.empty(cap, np.int64)
        self._unk_len = np.empty(cap, np.int64)
        self._unk_lines = np.empty(cap, np.int32)
        self._cap = cap

    def parse(self, buf: bytes) -> ParseResult:
        """Parse a newline-joined packet buffer; returns trimmed COO views
        plus the list of (unknown) raw lines for the Python slow path."""
        ptr = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p)
        # worst-case bound: every other byte a sample value or a 1-byte
        # line, for both the per-family arrays and the unknown list
        self._ensure_capacity(len(buf) // 2 + 2)
        i32, f32, i64 = ctypes.c_int32, ctypes.c_float, ctypes.c_int64
        ns = self._outs
        cap = i64(self._cap)
        lines = self._lib.vnt_parse(
            self._eng, ptr, len(buf),
            _ptr(self._c_rows, i32), _ptr(self._c_vals, f32),
            _ptr(self._c_rates, f32), cap, ctypes.byref(ns[0]),
            _ptr(self._g_rows, i32), _ptr(self._g_vals, f32),
            _ptr(self._g_lines, i32), cap, ctypes.byref(ns[1]),
            _ptr(self._h_rows, i32), _ptr(self._h_vals, f32),
            _ptr(self._h_wts, f32), cap, ctypes.byref(ns[2]),
            _ptr(self._s_rows, i32), _ptr(self._s_idx, i32),
            _ptr(self._s_rho, i32), cap, ctypes.byref(ns[3]),
            _ptr(self._l_rows, i32), _ptr(self._l_bins, i32),
            _ptr(self._l_wts, i32), cap, ctypes.byref(ns[6]),
            ctypes.byref(ns[7]),
            _ptr(self._unk_off, i64), _ptr(self._unk_len, i64),
            _ptr(self._unk_lines, i32), cap, ctypes.byref(ns[4]),
            ctypes.byref(ns[5]))
        res = ParseResult()
        res.lines = lines
        cn, gn, hn, sn, un = (ns[i].value for i in range(5))
        ln = ns[6].value
        res.samples = ns[5].value
        res.l_clamped = ns[7].value
        res.c_rows = self._c_rows[:cn]
        res.c_vals = self._c_vals[:cn]
        res.c_rates = self._c_rates[:cn]
        res.g_rows = self._g_rows[:gn]
        res.g_vals = self._g_vals[:gn]
        res.g_lines = self._g_lines[:gn]
        res.h_rows = self._h_rows[:hn]
        res.h_vals = self._h_vals[:hn]
        res.h_wts = self._h_wts[:hn]
        res.s_rows = self._s_rows[:sn]
        res.s_idx = self._s_idx[:sn]
        res.s_rho = self._s_rho[:sn]
        res.l_rows = self._l_rows[:ln]
        res.l_bins = self._l_bins[:ln]
        res.l_wts = self._l_wts[:ln]
        res.unknown = [
            buf[int(self._unk_off[i]):int(self._unk_off[i])
                + int(self._unk_len[i])]
            for i in range(un)]
        res.unknown_lines = self._unk_lines[:un]
        return res


def _view(addr: int, n: int, dtype):
    """Zero-copy numpy view over `n` elements of chunk memory at `addr`;
    valid until the chunk is released back to the pump."""
    if n == 0 or addr is None:
        return np.empty(0, dtype)
    nbytes = n * np.dtype(dtype).itemsize
    buf = (ctypes.c_char * nbytes).from_address(addr)
    return np.frombuffer(buf, dtype=dtype)


class PumpChunk:
    """One sealed chunk: trimmed zero-copy views plus counters, shaped
    like ParseResult so the ingester consumes either. The views alias
    pump memory and die at Pump.release."""

    __slots__ = ("handle", "lines", "samples", "dgrams", "dropped",
                 "reader", "dwell_ms",
                 "c_rows", "c_vals", "c_rates",
                 "g_rows", "g_vals", "g_lines", "h_rows", "h_vals", "h_wts",
                 "s_rows", "s_idx", "s_rho",
                 "l_rows", "l_bins", "l_wts", "l_clamped",
                 "unknown", "unknown_lines")


class Pump:
    """The C++-resident ingest loop: one native reader thread per socket
    runs poll -> recvmmsg -> parse -> accumulate without the GIL, behind
    per-reader SPSC rings; Python calls `next()` (GIL released while
    blocking) to receive sealed chunks of up to `chunk_cap` samples.

    Lifecycle: next()/release() from one dispatcher thread; stop() (any
    thread) halts the readers and unblocks next(); close() frees the
    native pump once the dispatcher is done."""

    def __init__(self, engine: Engine, fds, max_msgs: int = 512,
                 max_dgram: int = 65536, max_len: int = 65535,
                 chunk_cap: int = 65536, ring_slots: int = 4,
                 seal_age_ms: int = 100, poll_ms: int = 50):
        self._lib = load()
        self.engine = engine  # keepalive: pump threads read the C table
        fd_arr = (ctypes.c_int32 * len(fds))(*fds)
        self._p = self._lib.vnt_pump_new(
            engine.ptr, fd_arr, len(fds), max_msgs, max_dgram, max_len,
            chunk_cap, ring_slots, seal_age_ms, poll_ms)
        self._desc = ChunkDesc()
        self.nreaders = int(self._lib.vnt_pump_nreaders(self._p))

    def next(self, timeout_ms: int = 200) -> "PumpChunk | None":
        """Blocks up to timeout_ms for a sealed chunk. The returned
        chunk's arrays alias pump memory: call release() when done."""
        handle = self._lib.vnt_pump_next(
            self._p, timeout_ms, ctypes.byref(self._desc))
        if not handle:
            return None
        d = self._desc
        res = PumpChunk()
        res.handle = handle
        res.lines = d.lines
        res.samples = d.samples
        res.dgrams = d.dgrams
        res.dropped = d.dropped
        res.reader = d.reader
        res.dwell_ms = d.dwell_ms
        res.c_rows = _view(d.c_rows, d.c_n, np.int32)
        res.c_vals = _view(d.c_vals, d.c_n, np.float32)
        res.c_rates = _view(d.c_rates, d.c_n, np.float32)
        res.g_rows = _view(d.g_rows, d.g_n, np.int32)
        res.g_vals = _view(d.g_vals, d.g_n, np.float32)
        res.g_lines = _view(d.g_lines, d.g_n, np.int32)
        res.h_rows = _view(d.h_rows, d.h_n, np.int32)
        res.h_vals = _view(d.h_vals, d.h_n, np.float32)
        res.h_wts = _view(d.h_wts, d.h_n, np.float32)
        res.s_rows = _view(d.s_rows, d.s_n, np.int32)
        res.s_idx = _view(d.s_idx, d.s_n, np.int32)
        res.s_rho = _view(d.s_rho, d.s_n, np.int32)
        res.l_rows = _view(d.l_rows, d.l_n, np.int32)
        res.l_bins = _view(d.l_bins, d.l_n, np.int32)
        res.l_wts = _view(d.l_wts, d.l_n, np.int32)
        res.l_clamped = d.l_clamped
        if d.unk_n:
            offs = _view(d.unk_off, d.unk_n, np.int64)
            lens = _view(d.unk_len, d.unk_n, np.int64)
            # string_at copies: the slow-path lines outlive the chunk
            res.unknown = [
                ctypes.string_at(d.arena + int(offs[i]), int(lens[i]))
                for i in range(d.unk_n)]
            res.unknown_lines = _view(d.unk_line, d.unk_n, np.int32)
        else:
            res.unknown = []
            res.unknown_lines = np.empty(0, np.int32)
        return res

    def release(self, chunk: PumpChunk) -> None:
        self._lib.vnt_pump_release(self._p, chunk.handle)
        chunk.handle = None

    def stalls(self) -> int:
        return self._lib.vnt_pump_stalls(self._p)

    def live_readers(self) -> int:
        return self._lib.vnt_pump_live(self._p)

    def lost_lines(self) -> int:
        return self._lib.vnt_pump_lost_lines(self._p)

    def ring_stats(self):
        """Per-reader ring telemetry: (depths, capacities, sealed_totals,
        stall_totals) int64 arrays of length nreaders, fresh per call
        (the /metrics ingest.ring.* rows read these)."""
        out = np.empty((4, self.nreaders), np.int64)
        i64 = ctypes.c_int64
        self._lib.vnt_pump_ring_stats(
            self._p, _ptr(out[0], i64), _ptr(out[1], i64),
            _ptr(out[2], i64), _ptr(out[3], i64))
        return out[0], out[1], out[2], out[3]

    def signal_stop(self) -> None:
        """Sets the stop flag without joining, so the dispatcher can keep
        draining while the readers seal their partial chunks and exit."""
        if self._p:
            self._lib.vnt_pump_signal_stop(self._p)

    def stop(self) -> None:
        if self._p:
            self._lib.vnt_pump_stop(self._p)

    def close(self) -> None:
        if getattr(self, "_p", None):
            self._lib.vnt_pump_free(self._p)
            self._p = None

    def __del__(self):
        self.close()


class ImportBatch:
    """Output of parse_metric_list: per-family batches decoded straight
    from a MetricList wire body. Keys are the self-delimiting identity
    byte strings the import server caches stubs under; `consumed` counts
    every metric the parser walked, including ones of a family it does
    not decode (llhists), which it skips."""

    __slots__ = ("consumed", "c_keys", "c_vals", "g_keys", "g_vals",
                 "h_keys", "h_means", "h_weights", "h_min", "h_max",
                 "h_recip", "s_keys", "s_payloads")


def parse_metric_list(body: bytes, grid_slots: int, compression: float):
    """Decode a forwardrpc.MetricList request natively: counters and
    gauges as float64 values, digests re-bucketed into (n, grid_slots)
    float32 grids, set payloads as raw bytes. Returns an ImportBatch, or
    None when the body is empty or does not parse (the caller parses it
    with upb instead)."""
    lib = load()
    if not body:
        return None
    n = lib.vnt_import_count(body, len(body))
    if n < 0:
        return None
    cap = max(1, int(n))
    key_cap = len(body) + 16 * cap + 64
    key_buf = np.empty(key_cap, np.uint8)
    koff = [np.empty(cap, np.int64) for _ in range(4)]
    klen = [np.empty(cap, np.int64) for _ in range(4)]
    c_vals = np.empty(cap, np.float64)
    g_vals = np.empty(cap, np.float64)
    h_means = np.empty((cap, grid_slots), np.float32)
    h_weights = np.empty((cap, grid_slots), np.float32)
    h_min = np.empty(cap, np.float64)
    h_max = np.empty(cap, np.float64)
    h_recip = np.empty(cap, np.float64)
    s_payoff = np.empty(cap, np.int64)
    s_paylen = np.empty(cap, np.int64)
    ns = [ctypes.c_int64() for _ in range(4)]
    i64, f32, f64 = ctypes.c_int64, ctypes.c_float, ctypes.c_double
    rc = lib.vnt_import_parse(
        body, len(body), grid_slots, float(compression),
        _ptr(key_buf, ctypes.c_uint8), key_cap,
        _ptr(koff[0], i64), _ptr(klen[0], i64), _ptr(c_vals, f64), cap,
        ctypes.byref(ns[0]),
        _ptr(koff[1], i64), _ptr(klen[1], i64), _ptr(g_vals, f64), cap,
        ctypes.byref(ns[1]),
        _ptr(koff[2], i64), _ptr(klen[2], i64),
        _ptr(h_means, f32), _ptr(h_weights, f32), _ptr(h_min, f64),
        _ptr(h_max, f64), _ptr(h_recip, f64), cap, ctypes.byref(ns[2]),
        _ptr(koff[3], i64), _ptr(klen[3], i64),
        _ptr(s_payoff, i64), _ptr(s_paylen, i64), cap, ctypes.byref(ns[3]))
    if rc < 0:
        return None
    mv = memoryview(key_buf)  # slice per key: no full-buffer copy

    def keys_of(i):
        offs = koff[i][:ns[i].value].tolist()
        lens = klen[i][:ns[i].value].tolist()
        return [bytes(mv[o:o + ln]) for o, ln in zip(offs, lens)]

    out = ImportBatch()
    out.consumed = int(rc)
    out.c_keys = keys_of(0)
    out.c_vals = c_vals[:ns[0].value]
    out.g_keys = keys_of(1)
    out.g_vals = g_vals[:ns[1].value]
    nh = ns[2].value
    out.h_keys = keys_of(2)
    out.h_means = h_means[:nh]
    out.h_weights = h_weights[:nh]
    out.h_min = h_min[:nh]
    out.h_max = h_max[:nh]
    out.h_recip = h_recip[:nh]
    out.s_keys = keys_of(3)
    out.s_payloads = [body[o:o + ln] for o, ln in zip(
        s_payoff[:ns[3].value].tolist(), s_paylen[:ns[3].value].tolist())]
    return out


def decode_import_key(key: bytes):
    """Inverse of the C encoder's identity-key layout:
    [type][scope][varint nlen][name][varint tcount]{[varint tlen][tag]}*
    Returns (type_enum, scope_enum, name, [tags]). Decoding is STRICT
    utf-8 (raises UnicodeDecodeError/IndexError on bad input), as upb
    rejects invalid string fields: a lenient decode would let a poisoned
    metric flow downstream with a mangled name."""
    mtype, scope = key[0], key[1]
    pos = 2

    def varint(p):
        v = 0
        shift = 0
        while True:
            b = key[p]
            p += 1
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                return v, p
            shift += 7

    nlen, pos = varint(pos)
    name = key[pos:pos + nlen].decode("utf-8")
    pos += nlen
    tcount, pos = varint(pos)
    tags = []
    for _ in range(tcount):
        tlen, pos = varint(pos)
        tags.append(key[pos:pos + tlen].decode("utf-8"))
        pos += tlen
    return mtype, scope, name, tags
