"""DogStatsD wire-format parser (pure-Python reference path).

Grammar parity with reference samplers/parser.go:349-770: metrics
(`name:v1[:v2...]|type[|@rate][|#tag1,tag2]`), events (`_e{tl,xl}:title|text|...`)
and service checks (`_sc|name|status|...`), including multi-value packets,
magic scope tags (`veneurlocalonly`/`veneurglobalonly`), duplicate-section
rejection, and NaN/Inf rejection.

A copy of the JAX package's parser (the port imports nothing from it):
the slow path of the columnar ingesters calls `parse_metric_fast` per
line, and the SSF conversions turn span samples into UDPMetrics. The
uniqueness conversion takes its generator from the caller.
"""

from __future__ import annotations

import math
import time
import random
from typing import Callable, Dict, List, Optional, Sequence

from veneur_tpu_torch.samplers import metrics as m
from veneur_tpu_torch.samplers.metrics import MetricKey, MetricScope, UDPMetric, update_tags
from veneur_tpu_torch.util import tagging

# Special tag keys used to carry DogStatsD event fields through SSF samples
# (reference protocol/dogstatsd/protocol.go).
EVENT_AGGREGATION_KEY_TAG_KEY = "vdogstatsd_ak"
EVENT_ALERT_TYPE_TAG_KEY = "vdogstatsd_at"
EVENT_HOSTNAME_TAG_KEY = "vdogstatsd_hostname"
EVENT_IDENTIFIER_KEY = "vdogstatsd_ev"
EVENT_PRIORITY_TAG_KEY = "vdogstatsd_pri"
EVENT_SOURCE_TYPE_TAG_KEY = "vdogstatsd_st"

# Status values (reference ssf.SSFSample_Status)
STATUS_OK = 0
STATUS_WARNING = 1
STATUS_CRITICAL = 2
STATUS_UNKNOWN = 3

_TYPE_BY_LEAD = {
    ord("c"): m.COUNTER,
    ord("g"): m.GAUGE,
    ord("d"): m.HISTOGRAM,  # DogStatsD "distribution" is a histogram
    ord("h"): m.HISTOGRAM,
    ord("m"): m.TIMER,  # "ms"
    ord("s"): m.SET,
    # extension: "l" = log-linear histogram (Circllhist bins; exact
    # merges through the forward tier). Not in the reference grammar.
    ord("l"): m.LLHIST,
}


class ParseError(ValueError):
    pass


def _strict_float(value: bytes) -> float:
    """float() with Go strconv.ParseFloat strictness: no surrounding
    whitespace, no underscore separators."""
    if not value or value.strip() != value or b"_" in value:
        raise ValueError(f"invalid float syntax: {value!r}")
    return float(value)


def _strict_int(value: bytes) -> int:
    """int() with Go strconv.ParseInt strictness."""
    if not value or value.strip() != value or b"_" in value:
        raise ValueError(f"invalid int syntax: {value!r}")
    return int(value)


class Event:
    """A parsed DogStatsD event, represented as an SSF-sample-shaped record
    whose Datadog-specific fields ride in special tags (reference
    parser.go:511-657)."""

    __slots__ = ("name", "message", "timestamp", "tags")

    def __init__(self, name: str = "", message: str = "", timestamp: int = 0,
                 tags: Optional[Dict[str, str]] = None):
        self.name = name
        self.message = message
        self.timestamp = timestamp
        self.tags = tags if tags is not None else {}


class Parser:
    def __init__(self, extend_tags: Optional[Sequence[str]] = None,
                 cache_size: int = 1 << 16,
                 default_scope: MetricScope = MetricScope.MIXED):
        self.extend_tags = tagging.ExtendTags(extend_tags or ())
        # scope given to metrics that don't declare one; forward_only
        # servers pass GLOBAL_ONLY so every metric forwards (reference
        # server.go:547-552, worker.go:353-354). Explicit
        # veneurlocalonly/veneurglobalonly tags still win.
        self.default_scope = default_scope
        # metadata cache: everything except the value chunk parses once per
        # unique timeseries; steady-state traffic repeats keys, so the hot
        # path becomes one dict hit + value conversion
        self._meta_cache: Dict[bytes, tuple] = {}
        self._cache_size = cache_size

    def parse_metric_fast(self, packet: bytes,
                          cb: Callable[[UDPMetric], None]) -> None:
        """Cached parse: same grammar and errors as parse_metric."""
        type_start = packet.find(b"|")
        if type_start < 0:
            raise ParseError("need at least 1 pipe for type")
        value_start = packet.find(b":", 0, type_start)
        if value_start < 0:
            raise ParseError("need at least 1 colon")
        meta_key = packet[:value_start] + packet[type_start:]
        cached = self._meta_cache.get(meta_key)
        if cached is None:
            template: List[UDPMetric] = []
            self.parse_metric(packet, template.append)
            if not template:
                return
            t = template[0]
            cached = (t.key, t.digest, t.digest64, t.sample_rate,
                      t.tags, t.scope)
            if len(self._meta_cache) >= self._cache_size:
                self._meta_cache.clear()
            self._meta_cache[meta_key] = cached
            # first parse already produced the metrics; deliver and return
            for metric in template:
                cb(metric)
            return
        key, h32, h64, sample_rate, tags, scope = cached
        is_set = key.type == m.SET
        vc = packet[value_start + 1 : type_start]
        while vc:
            next_colon = vc.find(b":")
            if next_colon >= 0:
                value, vc = vc[:next_colon], vc[next_colon + 1 :]
            else:
                value, vc = vc, b""
            if is_set:
                val: object = value.decode("utf-8", "replace")
            else:
                try:
                    val = _strict_float(value)
                except ValueError:
                    raise ParseError(f"invalid number for metric value: {value!r}")
                if math.isnan(val) or math.isinf(val):
                    raise ParseError(f"invalid number for metric value: {value!r}")
            metric = UDPMetric(
                key=key, digest=h32, digest64=h64, value=val,
                sample_rate=sample_rate, tags=tags, scope=scope)
            cb(metric)

    # -- metrics ---------------------------------------------------------

    def parse_metric(self, packet: bytes, cb: Callable[[UDPMetric], None]) -> None:
        """Parse one DogStatsD metric packet, invoking cb once per value
        (multi-value packets emit several metrics sharing one key)."""
        type_start = packet.find(b"|")
        if type_start < 0:
            raise ParseError("need at least 1 pipe for type")
        value_start = packet.find(b":", 0, type_start)
        if value_start < 0:
            raise ParseError("need at least 1 colon")
        name_chunk = packet[:value_start]
        value_chunk = packet[value_start + 1 : type_start]
        if not name_chunk:
            raise ParseError("name cannot be empty")

        tags_start = packet.find(b"|", type_start + 1)
        if tags_start < 0:
            tags_start = len(packet)
        type_chunk = packet[type_start + 1 : tags_start]
        if not type_chunk:
            raise ParseError("metric type not specified")
        mtype = _TYPE_BY_LEAD.get(type_chunk[0])
        if mtype is None:
            raise ParseError("invalid type for metric")

        sample_rate = 1.0
        found_sample_rate = False
        temp_tags: Optional[List[str]] = None
        scope = self.default_scope

        # metadata sections after the type, each at most once
        while tags_start < len(packet):
            tags_next = packet.find(b"|", tags_start + 1)
            if tags_next < 0:
                tags_next = len(packet)
            chunk = packet[tags_start + 1 : tags_next]
            tags_start = tags_next
            if not chunk:
                raise ParseError("empty string after/between pipes")
            lead = chunk[0]
            if lead == ord("@"):
                if found_sample_rate:
                    raise ParseError("multiple sample rates specified")
                try:
                    sample_rate = _strict_float(chunk[1:])
                except ValueError:
                    raise ParseError(
                        f"invalid float for sample rate: {chunk[1:]!r}")
                if not (0 < sample_rate <= 1):
                    raise ParseError(
                        f"sample rate {sample_rate} must be >0 and <=1")
                found_sample_rate = True
            elif lead == ord("#"):
                if temp_tags is not None:
                    raise ParseError("multiple tag sections specified")
                temp_tags = chunk[1:].decode("utf-8", "replace").split(",")
                for i, tag in enumerate(temp_tags):
                    # escape hatches forcing host-local / global-only scope
                    if tag.startswith("veneurlocalonly"):
                        del temp_tags[i]
                        scope = MetricScope.LOCAL_ONLY
                        break
                    if tag.startswith("veneurglobalonly"):
                        del temp_tags[i]
                        scope = MetricScope.GLOBAL_ONLY
                        break
            else:
                raise ParseError(f"unknown section {chunk!r}")

        name = name_chunk.decode("utf-8", "replace")
        tags, joined, h32, h64 = update_tags(name, mtype, temp_tags, self.extend_tags)
        key = MetricKey(name, mtype, joined)

        # One metric per colon-separated value. Loop shape matters for parity
        # (reference parser.go:465-500): an empty value chunk emits nothing,
        # and a single trailing empty segment ("x:1:|c") is ignored, but empty
        # segments elsewhere ("x::1|c") are errors via number parsing.
        vc = value_chunk
        while vc:
            next_colon = vc.find(b":")
            if next_colon >= 0:
                value, vc = vc[:next_colon], vc[next_colon + 1 :]
            else:
                value, vc = vc, b""
            if mtype == m.SET:
                val: object = value.decode("utf-8", "replace")
            else:
                try:
                    val = _strict_float(value)
                except ValueError:
                    raise ParseError(f"invalid number for metric value: {value!r}")
                if math.isnan(val) or math.isinf(val):
                    raise ParseError(f"invalid number for metric value: {value!r}")
            metric = UDPMetric(
                key=key, digest=h32, value=val, sample_rate=sample_rate,
                tags=tags, scope=scope)
            metric.digest64 = h64  # host dictionary key
            cb(metric)

    # -- events ----------------------------------------------------------

    def parse_event(self, packet: bytes) -> Event:
        """Parse `_e{<title len>,<text len>}:title|text|<sections>`."""
        ret = Event(timestamp=int(time.time()), tags={EVENT_IDENTIFIER_KEY: ""})
        chunks = packet.split(b"|")

        starting_colon = chunks[0].find(b":")
        if starting_colon < 0:
            raise ParseError("event needs at least 1 colon")
        lengths = chunks[0][:starting_colon]
        if not lengths.startswith(b"_e{") or not lengths.endswith(b"}"):
            raise ParseError("event must have _e{} wrapper around length section")
        lengths = lengths[3:-1]
        comma = lengths.find(b",")
        if comma < 0:
            raise ParseError("event length section requires comma divider")
        try:
            title_len = _strict_int(lengths[:comma])
        except ValueError as e:
            raise ParseError(f"title length is not an integer: {e}")
        if title_len <= 0:
            raise ParseError("title length must be positive")
        try:
            text_len = _strict_int(lengths[comma + 1 :])
        except ValueError as e:
            raise ParseError(f"text length is not an integer: {e}")
        if text_len <= 0:
            raise ParseError("text length must be positive")

        title = chunks[0][starting_colon + 1 :]
        if len(title) != title_len:
            raise ParseError("actual title length did not match encoded length")
        ret.name = title.decode("utf-8", "replace")

        if len(chunks) < 2:
            raise ParseError("event must have at least 1 pipe for text")
        if len(chunks[1]) != text_len:
            raise ParseError("actual text length did not match encoded length")
        ret.message = chunks[1].decode("utf-8", "replace").replace("\\n", "\n")

        seen = set()

        def once(section: str):
            if section in seen:
                raise ParseError(f"multiple {section} sections")
            seen.add(section)

        for chunk in chunks[2:]:
            if not chunk:
                raise ParseError("empty string after/between pipes")
            if chunk.startswith(b"d:"):
                once("date")
                try:
                    ret.timestamp = _strict_int(chunk[2:])
                except ValueError as e:
                    raise ParseError(f"could not parse date: {e}")
            elif chunk.startswith(b"h:"):
                once("hostname")
                ret.tags[EVENT_HOSTNAME_TAG_KEY] = chunk[2:].decode("utf-8", "replace")
            elif chunk.startswith(b"k:"):
                once("aggregation")
                ret.tags[EVENT_AGGREGATION_KEY_TAG_KEY] = chunk[2:].decode(
                    "utf-8", "replace")
            elif chunk.startswith(b"p:"):
                once("priority")
                pri = chunk[2:].decode("utf-8", "replace")
                if pri not in ("normal", "low"):
                    raise ParseError("priority must be normal or low")
                ret.tags[EVENT_PRIORITY_TAG_KEY] = pri
            elif chunk.startswith(b"s:"):
                once("source")
                ret.tags[EVENT_SOURCE_TYPE_TAG_KEY] = chunk[2:].decode(
                    "utf-8", "replace")
            elif chunk.startswith(b"t:"):
                once("alert")
                alert = chunk[2:].decode("utf-8", "replace")
                if alert not in ("error", "warning", "info", "success"):
                    raise ParseError(
                        "alert level must be error, warning, info or success")
                ret.tags[EVENT_ALERT_TYPE_TAG_KEY] = alert
            elif chunk[0:1] == b"#":
                once("tags")
                tags = chunk[1:].decode("utf-8", "replace").split(",")
                ret.tags.update(tagging.parse_tag_slice_to_map(tags))
            else:
                raise ParseError("unrecognized metadata section")

        ret.tags = self.extend_tags.extend_map(ret.tags)
        return ret

    # -- service checks --------------------------------------------------

    def parse_service_check(self, packet: bytes) -> UDPMetric:
        """Parse `_sc|name|status|<sections>` into a status-typed UDPMetric."""
        chunks = packet.split(b"|")
        if chunks[0] != b"_sc":
            raise ParseError("no _sc prefix")
        if len(chunks) < 2:
            raise ParseError("need name section")
        if not chunks[1]:
            raise ParseError("empty name")
        name = chunks[1].decode("utf-8", "replace")
        if len(chunks) < 3:
            raise ParseError("need status section")
        status_map = {b"0": STATUS_OK, b"1": STATUS_WARNING,
                      b"2": STATUS_CRITICAL, b"3": STATUS_UNKNOWN}
        if chunks[2] not in status_map:
            raise ParseError("must have status of 0, 1, 2, or 3")
        value = status_map[chunks[2]]

        timestamp = int(time.time())
        hostname = ""
        message = ""
        scope = self.default_scope
        temp_tags: Optional[List[str]] = None
        seen = set()
        found_message = False

        def once(section: str):
            if section in seen:
                raise ParseError(f"multiple {section} sections")
            seen.add(section)

        for chunk in chunks[3:]:
            if not chunk:
                raise ParseError("empty string after/between pipes")
            if found_message:
                raise ParseError("message must be the last metadata section")
            if chunk.startswith(b"d:"):
                once("date")
                try:
                    timestamp = _strict_int(chunk[2:])
                except ValueError as e:
                    raise ParseError(f"could not parse date: {e}")
            elif chunk.startswith(b"h:"):
                once("hostname")
                hostname = chunk[2:].decode("utf-8", "replace")
            elif chunk.startswith(b"m:"):
                once("message")
                message = chunk[2:].decode("utf-8", "replace").replace("\\n", "\n")
                found_message = True
            elif chunk[0:1] == b"#":
                once("tags")
                temp_tags = chunk[1:].decode("utf-8", "replace").split(",")
                for i, tag in enumerate(temp_tags):
                    if tag == "veneurlocalonly":
                        del temp_tags[i]
                        scope = MetricScope.LOCAL_ONLY
                        break
                    if tag == "veneurglobalonly":
                        del temp_tags[i]
                        scope = MetricScope.GLOBAL_ONLY
                        break
            else:
                raise ParseError("unrecognized metadata section")

        tags, joined, h32, h64 = update_tags(name, m.STATUS, temp_tags, self.extend_tags)
        metric = UDPMetric(
            key=MetricKey(name, m.STATUS, joined), digest=h32, value=value,
            sample_rate=1.0, tags=tags, scope=scope, timestamp=timestamp,
            message=message, hostname=hostname)
        metric.digest64 = h64
        return metric

    # -- SSF conversion --------------------------------------------------

    def parse_metric_ssf(self, sample) -> UDPMetric:
        """Convert one SSFSample to a UDPMetric (reference
        parser.go:290-345 ParseMetricSSF): map the metric enum to a wire
        type, take the value from value/message/status by type, resolve
        scope from the enum plus magic tags."""
        from veneur_tpu_torch import ssf

        kind = {
            ssf.COUNTER: m.COUNTER,
            ssf.GAUGE: m.GAUGE,
            ssf.HISTOGRAM: m.HISTOGRAM,
            ssf.SET: m.SET,
            ssf.STATUS: m.STATUS,
        }.get(sample.metric)
        if kind is None:
            raise ParseError(f"invalid SSF metric type {sample.metric}")

        if kind == m.SET:
            value: object = sample.message
        elif kind == m.STATUS:
            value = int(sample.status)
        else:
            value = float(sample.value)

        scope = self.default_scope
        if sample.scope == 1:
            scope = MetricScope.LOCAL_ONLY
        elif sample.scope == 2:
            scope = MetricScope.GLOBAL_ONLY

        temp_tags = []
        for tk in sorted(sample.tags):
            if tk == "veneurlocalonly":
                scope = MetricScope.LOCAL_ONLY
            elif tk == "veneurglobalonly":
                scope = MetricScope.GLOBAL_ONLY
            else:
                temp_tags.append(f"{tk}:{sample.tags[tk]}")

        tags, joined, h32, h64 = update_tags(
            sample.name, kind, temp_tags, self.extend_tags)
        return UDPMetric(
            key=MetricKey(sample.name, kind, joined), digest=h32,
            digest64=h64, value=value,
            sample_rate=sample.sample_rate or 1.0, tags=tags, scope=scope)

    def convert_metrics(self, span) -> tuple:
        """Extract every valid sample in a span; returns
        (metrics, invalid_samples) (reference parser.go:154-171)."""
        metrics: List[UDPMetric] = []
        invalid = []
        for sample in span.metrics:
            try:
                metric = self.parse_metric_ssf(sample)
            except ParseError:
                invalid.append(sample)
                continue
            if not metric.name or metric.value is None:
                invalid.append(sample)
                continue
            metrics.append(metric)
        return metrics, invalid

    def convert_indicator_metrics(self, span, indicator_timer_name: str,
                                  objective_timer_name: str) -> List[UDPMetric]:
        """Derive SLI timers from an indicator span (reference
        parser.go:180-232): one timer tagged service+error, one
        global-only "objective" timer additionally tagged with the span
        name (overridable via the ssf_objective span tag)."""
        from veneur_tpu_torch import protocol, ssf

        if not span.indicator or not protocol.valid_trace(span):
            return []
        duration_ns = span.end_timestamp - span.start_timestamp
        error_tag = "true" if span.error else "false"
        out: List[UDPMetric] = []

        if indicator_timer_name:
            timer = ssf.timing(indicator_timer_name, duration_ns * 1e-9,
                               1e-9, {"service": span.service,
                                      "error": error_tag})
            out.append(self.parse_metric_ssf(timer))
        if objective_timer_name:
            objective = span.tags.get("ssf_objective") or span.name
            timer = ssf.timing(objective_timer_name, duration_ns * 1e-9,
                               1e-9, {"service": span.service,
                                      "objective": objective,
                                      "error": error_tag,
                                      "veneurglobalonly": "true"})
            out.append(self.parse_metric_ssf(timer))
        return out

    def convert_span_uniqueness_metrics(self, span, rng: random.Random,
                                        rate: float = 0.01) -> List[UDPMetric]:
        """Sampled Set counting unique span names per service/indicator
        (reference parser.go:238-259), kept with probability `rate` by
        one roll of `rng`."""
        from veneur_tpu_torch import ssf

        if not span.service:
            return []
        samples = ssf.randomly_sample(rng, rate, ssf.set_sample(
            "ssf.names_unique", span.name, {
                "indicator": "true" if span.indicator else "false",
                "service": span.service,
                "root_span": "true" if span.id == span.trace_id else "false",
            }))
        return [self.parse_metric_ssf(s) for s in samples]
