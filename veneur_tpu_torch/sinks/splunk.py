"""Splunk sink: spans to a HTTP Event Collector (HEC).

Behavioral parity with reference sinks/splunk/splunk.go (577 LoC): each
ingested span becomes one HEC event (newline-delimited JSON) on a
buffered submission channel; flushes batch-POST to
/services/collector/event with the `Splunk <token>` auth header.
Sampling keeps 1/N of traces by trace id, but *indicator* spans are
always kept (splunk.go's sampling rule).

A copy of veneur_tpu/sinks/splunk.py."""

from __future__ import annotations

import json
import logging
import queue
import threading
from typing import List

from veneur_tpu_torch.sinks import SpanSink, register_span_sink
from veneur_tpu_torch.util import http as vhttp

logger = logging.getLogger("veneur_tpu_torch.sinks.splunk")


def span_to_hec_event(span, host: str, index: str) -> dict:
    duration_ns = max(span.end_timestamp - span.start_timestamp, 0)
    return {
        "time": span.start_timestamp / 1e9,
        "host": host,
        "index": index,
        "sourcetype": span.service or "veneur",
        "event": {
            "trace_id": format(span.trace_id & ((1 << 64) - 1), "x"),
            "id": format(span.id & ((1 << 64) - 1), "x"),
            "parent_id": format(span.parent_id & ((1 << 64) - 1), "x"),
            "name": span.name,
            "service": span.service,
            "start_timestamp": span.start_timestamp,
            "end_timestamp": span.end_timestamp,
            "duration_ns": duration_ns,
            "error": bool(span.error),
            "indicator": bool(span.indicator),
            "tags": dict(span.tags),
        },
    }


class SplunkSpanSink(SpanSink):
    def __init__(self, name: str, hec_address: str, token: str,
                 hostname: str, index: str = "",
                 sample_rate: int = 1, max_buffer: int = 16_384,
                 timeout: float = 10.0, batch_size: int = 0,
                 submission_workers: int = 1):
        self._name = name
        self.url = hec_address.rstrip("/") + "/services/collector/event"
        self.token = token
        self.hostname = hostname
        self.index = index
        self.sample_rate = max(1, sample_rate)
        self.max_buffer = max_buffer
        self.timeout = timeout
        # hec_batch_size splits a flush into bodies of at most N events;
        # hec_submission_workers POST those bodies in parallel (reference
        # splunk.go:183-196's worker pool). The pool is persistent daemon
        # threads: per-flush executors would churn threads, and
        # non-daemon workers would block interpreter exit behind a hung
        # POST.
        self.batch_size = batch_size
        self.submission_workers = max(1, submission_workers)
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self.dropped = 0
        # submissions that completed after their own flush's accounting
        # deadline: credited into the NEXT flush's sent/drop totals so
        # late deliveries are not over-reported as drops
        self._late_sent = 0
        self._late_failed = 0
        self._work_q: queue.Queue = queue.Queue()
        if self.submission_workers > 1:
            for i in range(self.submission_workers):
                threading.Thread(
                    target=self._worker_loop, daemon=True,
                    name=f"splunk-hec-{name}-{i}").start()

    def _worker_loop(self) -> None:
        while True:
            fn = self._work_q.get()
            try:
                fn()
            except Exception:
                logger.exception("splunk HEC worker task failed")
            finally:
                self._work_q.task_done()

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "splunk"

    def ingest(self, span) -> None:
        # indicator spans always submit; others sample by trace id
        if not span.indicator and self.sample_rate > 1 \
                and span.trace_id % self.sample_rate != 0:
            return
        event = span_to_hec_event(span, self.hostname, self.index)
        with self._lock:
            if len(self._events) >= self.max_buffer:
                self.dropped += 1
                return
            self._events.append(event)

    def flush(self) -> None:
        import time as _time

        flush_start = _time.perf_counter()
        reportable = getattr(self, "_statsd", None) is not None
        with self._lock:
            events, self._events = self._events, []
            # reset only when the count can actually be reported, so an
            # unreportable interval's drops aren't silently discarded
            dropped = 0
            if reportable and self.dropped:
                dropped, self.dropped = self.dropped, 0
        # late completions from a prior flush's in-flight batches are
        # drained on every flush — including empty ones, else a quiet
        # tail would leave them unreported forever
        with self._lock:
            late_sent, self._late_sent = self._late_sent, 0
            late_failed, self._late_failed = self._late_failed, 0
        if not events:
            self.emit_flush_self_metrics(
                late_sent, flush_start, dropped + late_failed)
            return
        per = self.batch_size or len(events)
        batches = [events[i:i + per] for i in range(0, len(events), per)]
        sent = [0]
        failed = [0]
        accounted = [False]  # set once this flush's totals are emitted
        sent_lock = threading.Lock()

        def submit(batch: List[dict]) -> None:
            body = "\n".join(json.dumps(e, separators=(",", ":"))
                             for e in batch).encode()
            try:
                vhttp.post(
                    self.url, body, content_type="application/json",
                    headers={"Authorization": f"Splunk {self.token}"},
                    timeout=self.timeout)
                with sent_lock:
                    if accounted[0]:
                        with self._lock:
                            self._late_sent += len(batch)
                    else:
                        sent[0] += len(batch)
            except Exception as e:
                logger.error("splunk HEC POST failed: %s", e)
                with sent_lock:
                    if accounted[0]:
                        with self._lock:
                            self._late_failed += len(batch)
                    else:
                        failed[0] += len(batch)

        if self.submission_workers > 1 and len(batches) > 1:
            done = threading.Event()
            finished = [0]

            def task(batch: List[dict]):
                def run() -> None:
                    try:
                        submit(batch)
                    finally:
                        with sent_lock:
                            finished[0] += 1
                            if finished[0] == len(batches):
                                done.set()
                return run

            for batch in batches:
                self._work_q.put(task(batch))
            # bounded wait: a hung POST must not also hang the flush
            if not done.wait(timeout=self.timeout * 2):
                with sent_lock:
                    pending = len(batches) - finished[0]
                logger.warning(
                    "%d splunk HEC submissions still in flight at "
                    "flush accounting time", pending)
        else:
            for batch in batches:
                submit(batch)
        # failed batches' events are gone and count as drops; batches
        # still in flight at the deadline are NOT drops — their submits
        # credit _late_sent/_late_failed and land in a later flush's
        # totals (the workers may well deliver them after this point)
        with sent_lock:
            accounted[0] = True
            self.emit_flush_self_metrics(
                sent[0] + late_sent, flush_start,
                dropped + failed[0] + late_failed)


@register_span_sink("splunk")
def _factory(sink_config, server_config):
    c = sink_config.config
    from veneur_tpu_torch.config import parse_duration

    # hec_max_connection_lifetime / hec_connection_lifetime_jitter tune
    # the reference transport's connection recycling and
    # hec_tls_validate_hostname pins the TLS name; this reporter opens a
    # fresh connection per submission, so those knobs are accepted for
    # config compatibility with nothing to recycle or re-pin
    timeout = parse_duration(c.get("hec_ingest_timeout", 0) or 0) or 10.0
    return SplunkSpanSink(
        sink_config.name or "splunk",
        hec_address=c.get("hec_address", ""),
        token=str(c.get("hec_token", "")),
        hostname=server_config.hostname,
        index=c.get("hec_index", ""),
        sample_rate=int(c.get("span_sample_rate", 1)),
        max_buffer=int(c.get("hec_max_buffer", 16_384)),
        timeout=timeout,
        batch_size=int(c.get("hec_batch_size", 0)),
        submission_workers=int(c.get("hec_submission_workers", 1)))
