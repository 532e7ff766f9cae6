"""Columnar egress: wire encoders that consume FlushBatch arrays directly
(copied from veneur_tpu/core/egress.py; the `le:` tags come from the
port flusher's LE_TAGS).

A sink that calls `batch.materialize()` and loops `for m in metrics`
builds one InterMetric and one dict/proto/line per series, which at
full width dominates the flush (PERF.md §5). The encoders here walk the
FlushBatch sections instead:

* per-row byte fragments (the name/tag-dependent part of a series) are
  rendered ONCE per key lifetime and cached against the row's identity —
  the tags-list object ref that RowMeta shares with every FlushSection —
  so a steady-state flush pays only value formatting + `b"".join`;
* value columns format in bulk off the float64 arrays;
* llhist cumulative buckets ride the BucketSection's compact columns
  (each row's nonzero sorted bins and their cumulative counts) — no
  per-line recomputation and no pass over empty bins.

Parity is pinned against the legacy materialize() path and the JAX
package's encoders by tests/test_torch_egress.py (JSON key-order-
normalized for Datadog, byte-identical for Prometheus exposition and
Cortex remote-write wire); `extras` rows
(status checks, WAL backfill) keep the legacy per-metric rendering, which
also keeps exemplar/backfill clauses exact.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from veneur_tpu_torch.core.flusher import LE_TAGS, FlushBatch
from veneur_tpu_torch.samplers.metrics import InterMetric, MetricType

# fragment caches are bounded so a pathological tag churn can't grow a
# sink's cache without limit; at the cap the cache resets (one cold
# flush) rather than evicting piecemeal
FRAG_CACHE_CAP = 1 << 20

_MASK64 = (1 << 64) - 1
_INF = float("inf")


def _bulk_float_strs(values: np.ndarray) -> List[str]:
    """`str(v)` for every value — identical to the f-string/`json.dumps`
    rendering of the same python float (shortest-repr)."""
    return [repr(v) for v in values.tolist()]


def _json_num(v: float) -> str:
    """json.dumps' rendering of one float (Infinity/NaN spellings)."""
    if v == v and v != _INF and v != -_INF:
        return repr(v)
    if v != v:
        return "NaN"
    return "Infinity" if v > 0 else "-Infinity"


# --------------------------------------------------------------------------
# Datadog: series JSON by byte-assembly
# --------------------------------------------------------------------------


class DatadogColumnarEncoder:
    """`{"series": [...]}` body parts straight from FlushBatch columns.

    Per row the invariant JSON prefix — everything up to the inside of
    the `"tags"` array — is cached by `(name, id(tags), kind)`; the
    cache entry holds the tags-list ref so the id can't be recycled.
    A flush then appends `],"points":[[ts,value]]}` per row (buckets
    splice their `le:` tag into the open tags array first). Key order
    inside a series object differs from the legacy `_dd_metric` dict
    (tags rendered last); the parity suite compares key-order
    normalized, which is also the JSON object contract."""

    def __init__(self, sink):
        self.sink = sink
        # (name, id(tags), kind) -> (tags_ref, prefix_bytes|None, has_tags)
        self._frags: Dict[tuple, tuple] = {}

    def _prefix(self, name: str, tags: list,
                is_counter: bool) -> Tuple[Optional[bytes], bool]:
        """The series-object bytes through the open tags array (no
        closing `]}`), or None when the metric's name prefix drops it."""
        sink = self.sink
        if sink.metric_name_prefix_drops and any(
                name.startswith(p) for p in sink.metric_name_prefix_drops):
            return None, False
        out_tags = list(sink.tags)
        host = sink.hostname
        device = ""
        per_metric_excludes = ()
        for prefix, excludes in \
                sink.exclude_tags_prefix_by_prefix_metric.items():
            if name.startswith(prefix):
                per_metric_excludes = excludes
                break
        for t in tags:
            if t.startswith("host:"):
                host = t[5:]
            elif t.startswith("device:"):
                device = t[7:]
            elif (any(t.startswith(p) for p in sink.excluded_tag_prefixes)
                  or any(t.startswith(p) for p in per_metric_excludes)):
                continue
            else:
                out_tags.append(t)
        head = {
            "metric": name,
            "type": "rate" if is_counter else "gauge",
            "host": host,
            "interval": int(sink.interval) or 1,
        }
        if device:
            head["device"] = device
        head["tags"] = out_tags
        enc = json.dumps(head, separators=(",", ":")).encode()
        return enc[:-2], bool(out_tags)  # strip the tags-closing `]}`

    def _frag(self, name: str, tags: list, is_counter: bool):
        key = (name, id(tags), is_counter)
        ent = self._frags.get(key)
        if ent is None:
            if len(self._frags) >= FRAG_CACHE_CAP:
                self._frags.clear()
            prefix, has_tags = self._prefix(name, tags, is_counter)
            ent = self._frags[key] = (tags, prefix, has_tags)
        return ent

    def encode(self, batch: FlushBatch) -> Tuple[List[bytes],
                                                 List[InterMetric]]:
        """-> (series body parts, status checks). Joining parts with
        b"," inside `{"series":[...]}` is the POST body."""
        sink = self.sink
        parts: List[bytes] = []
        checks: List[InterMetric] = []
        ts_b = b"%d" % batch.timestamp
        interval = sink.interval
        for sec in batch.sections:
            is_counter = sec.mtype == MetricType.COUNTER
            vals = sec.values / interval if is_counter else sec.values
            if np.isfinite(vals).all():
                val_strs = [repr(v).encode() for v in vals.tolist()]
            else:
                val_strs = [_json_num(v).encode() for v in vals.tolist()]
            names = sec.names.tolist()
            tagrows = sec.tags.tolist()
            frag = self._frag
            for i, nm in enumerate(names):
                _tags, prefix, _ht = frag(nm, tagrows[i], is_counter)
                if prefix is None:
                    continue
                parts.append(prefix + b'],"points":[[' + ts_b + b","
                             + val_strs[i] + b"]]}")
        if batch.bucket_sections:
            les = _dd_le_json()
            for bs in batch.bucket_sections:
                names = bs.names.tolist()
                tagrows = bs.tags.tolist()
                off, bins = bs.offsets.tolist(), bs.bins.tolist()
                vals = [_json_num(v).encode()
                        for v in (bs.cum / interval).tolist()]
                tots = [_json_num(v).encode()
                        for v in (bs.total / interval).tolist()]
                for i, nm in enumerate(names):
                    _tags, prefix, has_tags = \
                        self._frag(nm, tagrows[i], True)
                    if prefix is None:
                        continue
                    head = prefix + b"," if has_tags else prefix
                    for j in range(off[i], off[i + 1]):
                        parts.append(head + les[bins[j]]
                                     + b'],"points":[[' + ts_b + b","
                                     + vals[j] + b"]]}")
                    parts.append(head + les[-1] + b'],"points":[['
                                 + ts_b + b"," + tots[i] + b"]]}")
        for m in batch.extras:
            if sink.metric_name_prefix_drops and any(
                    m.name.startswith(p)
                    for p in sink.metric_name_prefix_drops):
                continue
            if m.type == MetricType.STATUS:
                checks.append(m)
            else:
                parts.append(json.dumps(
                    sink._dd_metric(m), separators=(",", ":")).encode())
        return parts, checks


_DD_LE_JSON: Optional[List[bytes]] = None


def _dd_le_json() -> List[bytes]:
    global _DD_LE_JSON
    if _DD_LE_JSON is None:
        _DD_LE_JSON = [json.dumps(t).encode() for t in LE_TAGS]
    return _DD_LE_JSON


# --------------------------------------------------------------------------
# Prometheus: exposition text
# --------------------------------------------------------------------------


class PrometheusColumnarRenderer:
    """render_exposition, but off FlushBatch columns — byte-identical
    output (pinned by tests/test_egress.py). Caches the sanitized name
    per metric name and the rendered label interior per tags-list
    identity; section rows are never backfilled, so only `extras` pay
    the per-metric stamp/exemplar logic of the legacy renderer."""

    def __init__(self):
        self._names: Dict[str, str] = {}
        self._labels: Dict[int, tuple] = {}  # id(tags) -> (ref, interior)

    def _name(self, name: str) -> str:
        out = self._names.get(name)
        if out is None:
            from veneur_tpu_torch.sinks.cortex import sanitize_name
            if len(self._names) >= FRAG_CACHE_CAP:
                self._names.clear()
            out = self._names[name] = sanitize_name(name)
        return out

    def _label_interior(self, tags: list) -> str:
        ent = self._labels.get(id(tags))
        if ent is None:
            from veneur_tpu_torch.sinks.cortex import sanitize_label
            from veneur_tpu_torch.sinks.prometheus import escape_label_value
            if len(self._labels) >= FRAG_CACHE_CAP:
                self._labels.clear()
            parts = []
            for t in tags:
                k, _, v = t.partition(":")
                parts.append(
                    f'{sanitize_label(k)}="{escape_label_value(v)}"')
            ent = self._labels[id(tags)] = (tags, ",".join(parts))
        return ent[1]

    def render(self, batch: FlushBatch, exemplars=None,
               openmetrics: bool = False) -> str:
        from veneur_tpu_torch.sinks.prometheus import exemplar_clause_for

        lines: List[str] = []
        exemplified: set = set()
        for sec in batch.sections:
            names = sec.names.tolist()
            tagrows = sec.tags.tolist()
            val_strs = _bulk_float_strs(sec.values)
            check_ex = (exemplars is not None
                        and sec.mtype == MetricType.COUNTER)
            for i, nm in enumerate(names):
                interior = self._label_interior(tagrows[i])
                label_str = "{" + interior + "}" if interior else ""
                clause = ""
                if check_ex:
                    clause = exemplar_clause_for(
                        _ExemplarProbe(nm, tagrows[i]),
                        exemplars, exemplified)
                lines.append(f"{self._name(nm)}{label_str} "
                             f"{val_strs[i]}{clause}")
        if batch.bucket_sections:
            les = _prom_le_labels()
            le_tag_strs = LE_TAGS
            for bs in batch.bucket_sections:
                names = bs.names.tolist()
                tagrows = bs.tags.tolist()
                off, bins = bs.offsets.tolist(), bs.bins.tolist()
                vals, tots = bs.cum.tolist(), bs.total.tolist()
                for i, nm in enumerate(names):
                    sname = self._name(nm)
                    interior = self._label_interior(tagrows[i])
                    pre = "{" + interior + "," if interior else "{"
                    s, e = off[i], off[i + 1]
                    for k, v in zip(bins[s:e] + [-1], vals[s:e] + [tots[i]]):
                        clause = ""
                        if exemplars is not None:
                            clause = exemplar_clause_for(
                                _ExemplarProbe(
                                    nm, tagrows[i] + [le_tag_strs[k]]),
                                exemplars, exemplified)
                        lines.append(f"{sname}{pre}{les[k]}}} "
                                     f"{v}{clause}")
        for m in batch.extras:
            if m.type == MetricType.STATUS:
                continue
            interior = self._label_interior(m.tags)
            label_str = "{" + interior + "}" if interior else ""
            clause = exemplar_clause_for(m, exemplars, exemplified)
            if m.backfilled:
                stamp = (f" {int(m.timestamp)}" if openmetrics
                         else f" {int(m.timestamp) * 1000}")
            else:
                stamp = ""
            lines.append(f"{self._name(m.name)}{label_str} {m.value}"
                         f"{stamp}{clause}")
        return "\n".join(lines) + ("\n" if lines else "")


class _ExemplarProbe:
    """Duck-typed COUNTER InterMetric for exemplar_clause_for (the
    clause logic only reads name/tags/type)."""

    __slots__ = ("name", "tags")
    type = MetricType.COUNTER

    def __init__(self, name: str, tags: list):
        self.name = name
        self.tags = tags


_PROM_LE: Optional[List[str]] = None


def _prom_le_labels() -> List[str]:
    """`le="<bound>"` rendered label per sorted bin (+Inf last) —
    bounds never contain escapable characters."""
    global _PROM_LE
    if _PROM_LE is None:
        _PROM_LE = [f'le="{t.partition(":")[2]}"' for t in LE_TAGS]
    return _PROM_LE


# --------------------------------------------------------------------------
# Cortex: remote-write protobuf TimeSeries frames
# --------------------------------------------------------------------------


class CortexColumnarEncoder:
    """WriteRequest TimeSeries frames hand-packed from FlushBatch
    columns, byte-identical to `_series` + `encode_write_request`
    (pinned by tests/test_egress.py). The sorted Label block per row
    caches against (name, tags identity); samples assemble from the
    bulk little-endian float64 dump of the value column plus one
    precomputed timestamp varint. Bucket rows cache the label block
    split at the `le` insertion point so every bin line is two joins.

    Returns the series FRAMES (field-1 bytes); concatenating a chunk of
    frames IS encode_write_request's output for that chunk, so the
    sink's batch_write_size chunking and snappy+POST stay unchanged."""

    def __init__(self, sink):
        self.sink = sink
        self._blocks: Dict[tuple, tuple] = {}   # (name,id) -> (ref, block)
        self._bucket_blocks: Dict[tuple, tuple] = {}  # -> (ref, pre, post)

    def _label_items(self, name: str, tags: list) -> List[tuple]:
        from veneur_tpu_torch.sinks.cortex import sanitize_label, sanitize_name

        sink = self.sink
        labels = {"__name__": sanitize_name(name)}
        for t in tags:
            k, _, v = t.partition(":")
            if k in sink.excluded_tags:
                continue
            labels[sanitize_label(k)] = v  # last write wins on dupes
        if sink.hostname:  # section rows carry no per-metric hostname
            labels.setdefault("host", sink.hostname)
        return sorted(labels.items())

    def _block(self, name: str, tags: list) -> bytes:
        key = (name, id(tags))
        ent = self._blocks.get(key)
        if ent is None:
            from veneur_tpu_torch.sinks.cortex import _encode_label, _field_bytes
            if len(self._blocks) >= FRAG_CACHE_CAP:
                self._blocks.clear()
            block = b"".join(_field_bytes(1, _encode_label(k, v))
                             for k, v in self._label_items(name, tags))
            ent = self._blocks[key] = (tags, block)
        return ent[1]

    def _bucket_block(self, name: str, tags: list) -> Tuple[bytes, bytes]:
        """(pre, post) label-block halves around the sorted insertion
        point of the `le` label; a base `le:` tag is dropped here
        because the bucket's own le label overwrites it (legacy: the
        appended le tag wins last-write in the labels dict)."""
        key = (name, id(tags))
        ent = self._bucket_blocks.get(key)
        if ent is None:
            from veneur_tpu_torch.sinks.cortex import _encode_label, _field_bytes
            if len(self._bucket_blocks) >= FRAG_CACHE_CAP:
                self._bucket_blocks.clear()
            items = [kv for kv in self._label_items(name, tags)
                     if kv[0] != "le"]
            idx = 0
            while idx < len(items) and items[idx][0] < "le":
                idx += 1
            pre = b"".join(_field_bytes(1, _encode_label(k, v))
                           for k, v in items[:idx])
            post = b"".join(_field_bytes(1, _encode_label(k, v))
                            for k, v in items[idx:])
            ent = self._bucket_blocks[key] = (tags, pre, post)
        return ent[1], ent[2]

    def encode(self, batch: FlushBatch) -> Tuple[List[bytes], int]:
        """-> (TimeSeries frames in legacy order, max metric timestamp
        seen). The max-timestamp fold rides the encode pass (the legacy
        flush re-scanned every metric for it in monotonic mode)."""
        from veneur_tpu_torch.sinks.cortex import (
            _encode_exemplar, _field_bytes, _varint, encode_write_request,
        )

        sink = self.sink
        frames: List[bytes] = []
        exemplified: set = set()
        max_ts = 0
        ts = batch.timestamp
        ts_tail = b"\x10" + _varint((ts * 1000) & _MASK64)
        sample_len = 9 + len(ts_tail)
        sample_hdr = b"\x12" + _varint(sample_len)
        mono = sink.convert_counters_to_monotonic
        check_ex = sink._exemplars is not None
        monotonic = sink._monotonic
        for sec in batch.sections:
            n = sec.names.shape[0]
            if n == 0:
                continue
            if ts > max_ts:
                max_ts = ts
            is_counter = sec.mtype == MetricType.COUNTER
            names = sec.names.tolist()
            tagrows = sec.tags.tolist()
            if is_counter and mono:
                for nm, tg, v in zip(names, tagrows,
                                     sec.values.tolist()):
                    key = (nm, tuple(sorted(tg)), "")
                    monotonic[key] = monotonic.get(key, 0.0) + v
                continue
            vb = sec.values.astype("<f8").tobytes()
            row_ex = check_ex and is_counter
            for i, nm in enumerate(names):
                body = (self._block(nm, tagrows[i]) + sample_hdr
                        + b"\x09" + vb[8 * i:8 * i + 8] + ts_tail)
                if row_ex:
                    ex = self._exemplar(nm, tagrows[i], exemplified)
                    if ex is not None:
                        body += _field_bytes(3, _encode_exemplar(*ex))
                frames.append(b"\x0a" + _varint(len(body)) + body)
        if batch.bucket_sections:
            les = _cortex_le_labels()
            le_strs = LE_TAGS
            for bs in batch.bucket_sections:
                if bs.names.shape[0] and ts > max_ts:
                    max_ts = ts
                names = bs.names.tolist()
                tagrows = bs.tags.tolist()
                off, bins = bs.offsets.tolist(), bs.bins.tolist()
                if mono:
                    vals, tots = bs.cum.tolist(), bs.total.tolist()
                else:
                    vb = bs.cum.astype("<f8").tobytes()
                    tb = bs.total.astype("<f8").tobytes()
                for i, nm in enumerate(names):
                    s, e = off[i], off[i + 1]
                    if mono:
                        base = tagrows[i]
                        for j in range(s, e):
                            key = (nm, tuple(sorted(
                                base + [le_strs[bins[j]]])), "")
                            monotonic[key] = (monotonic.get(key, 0.0)
                                              + vals[j])
                        key = (nm, tuple(sorted(base + ["le:+Inf"])), "")
                        monotonic[key] = (monotonic.get(key, 0.0)
                                          + tots[i])
                        continue
                    pre, post = self._bucket_block(nm, tagrows[i])
                    for k, v in zip(bins[s:e] + [-1],
                                    [vb[8 * j:8 * j + 8]
                                     for j in range(s, e)]
                                    + [tb[8 * i:8 * i + 8]]):
                        body = (pre + les[k] + post + sample_hdr + b"\x09"
                                + v + ts_tail)
                        if check_ex:
                            ex = self._exemplar(
                                nm, tagrows[i] + [le_strs[k]], exemplified)
                            if ex is not None:
                                body += _field_bytes(
                                    3, _encode_exemplar(*ex))
                        frames.append(b"\x0a" + _varint(len(body)) + body)
        for m in batch.extras:
            if m.timestamp > max_ts:
                max_ts = m.timestamp
            if m.type == MetricType.STATUS:
                continue
            if m.type == MetricType.COUNTER and mono:
                key = (m.name, tuple(sorted(m.tags)), m.hostname)
                monotonic[key] = monotonic.get(key, 0.0) + float(m.value)
                continue
            row = sink._series(m)
            entry = sink._exemplar_entry(m, exemplified)
            if entry is not None:
                from veneur_tpu_torch.trace.store import trace_id_hex
                tid, ev, ets = entry
                row = row + ((trace_id_hex(tid), float(ev),
                              int(ets * 1000)),)
            frames.append(encode_write_request([row]))
        return frames, max_ts

    def _exemplar(self, name: str, tags: list, exemplified: set):
        """sink._exemplar_entry for a columnar COUNTER row, converted
        to _encode_exemplar's argument tuple."""
        entry = self.sink._exemplar_entry(
            _ExemplarProbe(name, tags), exemplified)
        if entry is None:
            return None
        from veneur_tpu_torch.trace.store import trace_id_hex
        tid, ev, ets = entry
        return trace_id_hex(tid), float(ev), int(ets * 1000)


_CORTEX_LE: Optional[List[bytes]] = None


def _cortex_le_labels() -> List[bytes]:
    global _CORTEX_LE
    if _CORTEX_LE is None:
        from veneur_tpu_torch.sinks.cortex import _encode_label, _field_bytes
        _CORTEX_LE = [
            _field_bytes(1, _encode_label("le", t.partition(":")[2]))
            for t in LE_TAGS]
    return _CORTEX_LE
