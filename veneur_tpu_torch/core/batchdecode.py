"""Numpy columnar DogStatsD batch decoder: the pure-Python counterpart
of the native (C++) batch parser (a copy of veneur_tpu/core/batchdecode.py).

The port's server takes it when `tpu.disable_native_parser` is set.
Instead of the per-packet object path — one ``UDPMetric`` allocation,
one dict walk, and one table lock per sample — this decoder keeps the
columnar shape of the native path in pure Python: a whole packet batch
parses into the SAME per-family COO columns (`ParseResult` duck type),
so the apply side (`_ColumnarIngesterBase._ingest`) is shared with
the native path and pays one ``add_batch`` per family per batch instead
of one lock per sample.

What is vectorized: column assembly, llhist binning
(``llhist_ref.bin_index`` over the whole value array — float64, so bin
parity with the scalar path is definitional), the gauge last-write-wins
ordering merge, and the column-store batch applies. What is not: the
per-token strict-float validation, which deliberately reuses the scalar
parser's ``_strict_float`` so accept/reject behavior can never drift.

Parity contract (same as dogstatsd.cc): any line this decoder cannot
take bit-exactly the way the scalar parser would — events, service
checks, unknown keys, malformed values, non-ASCII set members,
NaN/Inf — is returned in ``unknown`` for the per-packet slow path, and
a malformed segment rolls back the WHOLE line's samples first.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from veneur_tpu_torch.ops import hll_ref, llhist_ref
from veneur_tpu_torch.samplers.parser import _strict_float

# family codes, mirroring dogstatsd.cc / veneur_tpu_torch.native (written
# here as literals so this module never touches the ctypes loader)
FAM_COUNTER = 0
FAM_GAUGE = 1
FAM_HISTO = 2
FAM_SET = 3
FAM_LLHIST = 4


class PyParseResult:
    """Duck-typed ``native.ParseResult``: trimmed per-family COO columns
    plus the deferred raw lines. llhist columns come out pre-binned
    (``l_bins``/``l_wts``/``l_clamped``), matching the native chunk
    layout so the shared apply path has one llhist contract."""

    __slots__ = ("lines", "samples", "c_rows", "c_vals", "c_rates",
                 "g_rows", "g_vals", "g_lines", "h_rows", "h_vals", "h_wts",
                 "s_rows", "s_idx", "s_rho",
                 "l_rows", "l_bins", "l_wts", "l_clamped",
                 "unknown", "unknown_lines")


_EMPTY_I32 = np.empty(0, np.int32)
_EMPTY_F32 = np.empty(0, np.float32)


class ColumnarDecoder:
    """One server's pure-Python intern table + columnar parse.

    The table maps a line's meta-key bytes (name chunk + everything from
    the type pipe onward) to ``(family, row, rate)`` — the same identity
    the C++ engine interns — filled by the slow path via ``register``,
    so each unique timeseries pays the object path exactly once.

    Thread safety: ``register`` may race ``parse`` from other reader
    threads; a plain dict assignment is atomic under the GIL, and a
    parse that misses a just-registered key only defers one more line.
    """

    def __init__(self):
        self.table: Dict[bytes, Tuple[int, int, float]] = {}

    def register(self, meta_key: bytes, family: int, row: int,
                 rate: float) -> None:
        self.table[meta_key] = (family, int(row), float(rate))

    def size(self) -> int:
        return len(self.table)

    def parse(self, buf: bytes) -> PyParseResult:
        table = self.table
        c_rows: List[int] = []
        c_vals: List[float] = []
        c_rates: List[float] = []
        g_rows: List[int] = []
        g_vals: List[float] = []
        g_lines: List[int] = []
        h_rows: List[int] = []
        h_vals: List[float] = []
        h_wts: List[float] = []
        s_rows: List[int] = []
        s_idx: List[int] = []
        s_rho: List[int] = []
        l_rows: List[int] = []
        l_vals: List[float] = []
        l_wts: List[float] = []
        unknown: List[bytes] = []
        unknown_lines: List[int] = []
        cols_by_family = (
            (c_rows, c_vals, c_rates), (g_rows, g_vals, g_lines),
            (h_rows, h_vals, h_wts), (s_rows, s_idx, s_rho),
            (l_rows, l_vals, l_wts))
        hash_member = hll_ref.hash_member
        pos_val = hll_ref.pos_val
        isnan, isinf = math.isnan, math.isinf
        line_no = -1
        samples = 0
        for line in buf.split(b"\n"):
            if not line:
                continue
            line_no += 1
            if line.startswith(b"_e{") or line.startswith(b"_sc"):
                unknown.append(line)
                unknown_lines.append(line_no)
                continue
            type_start = line.find(b"|")
            if type_start < 0:
                unknown.append(line)
                unknown_lines.append(line_no)
                continue
            value_start = line.find(b":", 0, type_start)
            if value_start < 0:
                unknown.append(line)
                unknown_lines.append(line_no)
                continue
            ent = table.get(line[:value_start] + line[type_start:])
            if ent is None:
                unknown.append(line)
                unknown_lines.append(line_no)
                continue
            family, row, rate = ent
            toks = line[value_start + 1:type_start].split(b":")
            if toks and toks[-1] == b"":
                toks.pop()  # trailing empty segment is ignored (parity)
            cols = cols_by_family[family]
            mark = len(cols[0])  # a line only appends to its own family
            n_before = samples
            bad = False
            for tok in toks:
                if family == FAM_SET:
                    # non-ASCII members go to Python: the scalar parser
                    # round-trips them through UTF-8-with-replacement,
                    # changing the hashed bytes
                    if not tok.isascii():
                        bad = True
                        break
                    idx, rho = pos_val(hash_member(tok))
                    cols[0].append(row)
                    cols[1].append(idx)
                    cols[2].append(rho)
                else:
                    try:
                        v = _strict_float(tok)
                    except ValueError:
                        bad = True
                        break
                    if isnan(v) or isinf(v):
                        bad = True
                        break
                    cols[0].append(row)
                    cols[1].append(v)
                    if family == FAM_GAUGE:
                        cols[2].append(line_no)
                    elif family == FAM_COUNTER:
                        cols[2].append(rate)
                    elif family == FAM_LLHIST:
                        # scalar-path parity: 1e-9 rate floor before the
                        # reciprocal (LLHistTable.add does the same)
                        cols[2].append(1.0 / max(rate, 1e-9))
                    else:  # histo weight
                        cols[2].append(1.0 / rate)
                samples += 1
            if bad:
                # a malformed segment fails the whole line in the scalar
                # parser: roll back everything this line emitted
                for col in cols:
                    del col[mark:]
                samples = n_before
                unknown.append(line)
                unknown_lines.append(line_no)
        res = PyParseResult()
        res.lines = line_no + 1
        res.samples = samples
        res.unknown = unknown
        res.unknown_lines = unknown_lines
        res.c_rows = np.asarray(c_rows, np.int32)
        res.c_vals = np.asarray(c_vals, np.float32)
        res.c_rates = np.asarray(c_rates, np.float32)
        res.g_rows = np.asarray(g_rows, np.int32)
        res.g_vals = np.asarray(g_vals, np.float32)
        res.g_lines = np.asarray(g_lines, np.int32)
        res.h_rows = np.asarray(h_rows, np.int32)
        res.h_vals = np.asarray(h_vals, np.float32)
        res.h_wts = np.asarray(h_wts, np.float32)
        res.s_rows = np.asarray(s_rows, np.int32)
        res.s_idx = np.asarray(s_idx, np.int32)
        res.s_rho = np.asarray(s_rho, np.int32)
        res.l_rows = np.asarray(l_rows, np.int32)
        if l_rows:
            # vectorized float64 binning — the same llhist_ref code the
            # scalar path runs per value, so parity is definitional
            vals64 = np.asarray(l_vals, np.float64)
            bins, wts = _bin_llhist(vals64, np.asarray(l_wts, np.float64))
            res.l_bins = bins
            res.l_wts = wts
            res.l_clamped = int(
                wts[llhist_ref.clamped_mask(vals64)].sum())
        else:
            res.l_bins = _EMPTY_I32
            res.l_wts = _EMPTY_I32
            res.l_clamped = 0
        return res


def _bin_llhist(vals64: np.ndarray, wts: np.ndarray):
    """(values, 1/rate weights) -> (bin ids int32, integral weights
    int32); weights round half-to-even like the scalar path's round(),
    clipped into int32 (a valid @1e-10 rate must saturate, not wrap)."""
    bins = llhist_ref.bin_index(vals64).astype(np.int32, copy=False)
    w = np.clip(np.rint(wts), 1.0, np.iinfo(np.int32).max).astype(np.int32)
    return bins, w
