"""SignalFx sink.

Behavioral parity with reference sinks/signalfx/signalfx.go (681 LoC):
InterMetrics become SignalFx datapoints with dimensions; a `vary_key_by`
tag routes each metric to a per-token client (reference's dynamic
per-token clients, signalfx.go:491-588); counters are cumulative counts,
gauges and status checks gauges (signalfx.go:573-582); counters can drop
the hostname dimension when a configured tag is present
(drop_host_with_tag_key, signalfx.go:566-571); batches chunk at
flush_max_per_body (collection.submit, signalfx.go:96-141). DogStatsD
events flush to /v2/event with name/description truncation and
Datadog-markdown stripping (signalfx.go:601-681). Datapoints POST to
/v2/datapoint as JSON (the reference uses the sfx protobuf client; the
JSON ingest API carries the same datapoint model).

Copied from veneur_tpu/sinks/signalfx.py.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Sequence

from veneur_tpu_torch.config import parse_duration
from veneur_tpu_torch.samplers.metrics import InterMetric, MetricType
from veneur_tpu_torch.samplers.parser import EVENT_IDENTIFIER_KEY
from veneur_tpu_torch.sinks import MetricSink, register_metric_sink
from veneur_tpu_torch.util import http as vhttp

logger = logging.getLogger("veneur_tpu_torch.sinks.signalfx")

EVENT_NAME_MAX_LENGTH = 256  # reference signalfx.go:30
EVENT_DESCRIPTION_MAX_LENGTH = 256  # reference signalfx.go:31


class SignalFxMetricSink(MetricSink):
    def __init__(self, name: str, api_key: str, endpoint: str,
                 hostname: str, hostname_tag: str = "host",
                 vary_key_by: str = "", per_tag_tokens: Dict[str, str] = None,
                 excluded_tags: Sequence[str] = (),
                 drop_host_with_tag_key: str = "",
                 flush_max_per_body: int = 0, timeout: float = 10.0,
                 metric_tag_prefix_drops: Sequence[str] = (),
                 preferred_vary_key_by: str = "",
                 api_endpoint: str = "https://api.signalfx.com",
                 dynamic_per_tag_tokens: bool = False,
                 dynamic_refresh_period_s: float = 0.0):
        self._name = name
        self.api_key = api_key
        self.endpoint = endpoint.rstrip("/")
        self.hostname = hostname
        self.hostname_tag = hostname_tag
        self.vary_key_by = vary_key_by
        self.per_tag_tokens = per_tag_tokens or {}
        self.excluded_tags = set(excluded_tags)
        self.drop_host_with_tag_key = drop_host_with_tag_key
        self.flush_max_per_body = flush_max_per_body
        self.timeout = timeout
        # metrics carrying a tag with any of these prefixes are skipped
        # outright (signalfx.go:510-518)
        self.metric_tag_prefix_drops = tuple(metric_tag_prefix_drops or ())
        # token-routing dimension that beats vary_key_by when both are
        # present on a metric (signalfx.go:543-560; the reference also
        # parses vary_key_by_favor_common_dimensions but never reads it,
        # so it is accepted-and-ignored here too)
        self.preferred_vary_key_by = preferred_vary_key_by
        self.skipped_total = 0
        # dynamic per-tag tokens: a refresher polls the SignalFx org
        # token API and swaps the routing table (signalfx.go:352-445)
        self.api_endpoint = api_endpoint.rstrip("/")
        self._tokens_lock = threading.Lock()
        self._refresher: threading.Thread = None
        if dynamic_per_tag_tokens and dynamic_refresh_period_s > 0:
            self._refresher = threading.Thread(
                target=self._refresh_tokens_loop,
                args=(dynamic_refresh_period_s,),
                name=f"sfx-token-refresh-{name}", daemon=True)
            self._refresher.start()

    def _refresh_tokens_loop(self, period_s: float) -> None:
        import time as _time
        while True:
            _time.sleep(period_s)
            try:
                tokens = fetch_api_keys(
                    self.api_endpoint, self.api_key, timeout=self.timeout)
            except Exception as e:
                logger.warning("failed to fetch tokens from SignalFx: %s", e)
                continue
            with self._tokens_lock:
                self.per_tag_tokens.update(tokens)

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "signalfx"

    def flush(self, metrics: List[InterMetric]) -> None:
        # datapoints grouped by access token (vary_key_by routing)
        by_token: Dict[str, Dict[str, list]] = {}
        prefix_drops = self.metric_tag_prefix_drops
        for m in metrics:
            if prefix_drops and any(
                    t.startswith(p) for p in prefix_drops for t in m.tags):
                self.skipped_total += 1
                continue
            dims = {self.hostname_tag: m.hostname or self.hostname}
            for t in m.tags:
                k, _, v = t.partition(":")
                dims[k] = v
            # preferred_vary_key_by beats vary_key_by when its dimension
            # is present; routing sees the full dimension set — excluded
            # tags are deleted only after key selection
            # (signalfx.go:534-564)
            vary_val = ""
            if self.preferred_vary_key_by:
                vary_val = dims.get(self.preferred_vary_key_by, "")
            if not vary_val and self.vary_key_by:
                vary_val = dims.get(self.vary_key_by, "")
            if vary_val:
                with self._tokens_lock:
                    token = self.per_tag_tokens.get(vary_val, self.api_key)
            else:
                token = self.api_key
            for k in self.excluded_tags:
                dims.pop(k, None)
            if (m.type == MetricType.COUNTER and self.drop_host_with_tag_key
                    and self.drop_host_with_tag_key in dims):
                dims.pop(self.hostname_tag, None)
            point = {
                "metric": m.name,
                "value": m.value,
                "timestamp": m.timestamp * 1000,
                "dimensions": dims,
            }
            bucket = by_token.setdefault(token, {"counter": [], "gauge": []})
            if m.type == MetricType.COUNTER:
                bucket["counter"].append(point)
            else:
                # gauges and status checks both emit as gauges
                # (signalfx.go:573-582)
                bucket["gauge"].append(point)
        threads = []
        for token, payload in by_token.items():
            for chunk in self._chunk(payload):
                t = threading.Thread(
                    target=self._post_datapoints, args=(token, chunk),
                    daemon=True)
                t.start()
                threads.append(t)
        for t in threads:
            t.join()

    def _chunk(self, payload: Dict[str, list]) -> List[Dict[str, list]]:
        """Split a token's datapoints at flush_max_per_body (the
        reference's collection.submit batching)."""
        per = self.flush_max_per_body
        total = sum(len(v) for v in payload.values())
        if not per or total <= per:
            out = {k: v for k, v in payload.items() if v}
            return [out] if out else []
        flat = [(kind, p) for kind, pts in payload.items() for p in pts]
        chunks = []
        for i in range(0, len(flat), per):
            chunk: Dict[str, list] = {}
            for kind, p in flat[i:i + per]:
                chunk.setdefault(kind, []).append(p)
            chunks.append(chunk)
        return chunks

    def _post_datapoints(self, token: str, payload: Dict[str, list]) -> None:
        try:
            vhttp.post_json(
                f"{self.endpoint}/v2/datapoint", payload,
                headers={"X-SF-Token": token}, compress="gzip",
                timeout=self.timeout)
        except Exception as e:
            logger.error("signalfx POST failed: %s", e)

    def flush_other_samples(self, samples: Sequence[Any]) -> None:
        """DogStatsD events -> SignalFx /v2/event (reference
        signalfx.go:601-681 FlushOtherSamples/reportEvent); non-event
        samples are ignored."""
        events = []
        for s in samples:
            tags = dict(getattr(s, "tags", {}) or {})
            if EVENT_IDENTIFIER_KEY not in tags:
                continue
            tags.pop(EVENT_IDENTIFIER_KEY, None)
            dims = {self.hostname_tag: self.hostname}
            for k, v in tags.items():
                if k not in self.excluded_tags:
                    dims[k] = v
            name = getattr(s, "name", "")[:EVENT_NAME_MAX_LENGTH]
            message = getattr(s, "message", "")
            if len(message) > EVENT_DESCRIPTION_MAX_LENGTH:
                message = message[:EVENT_DESCRIPTION_MAX_LENGTH]
            # strip the Datadog markdown fences SignalFx has no use for
            message = message.replace("%%% \n", "", 1)
            message = message.replace("\n %%%", "", 1)
            message = message.strip()
            events.append({
                "eventType": name,
                "category": "USER_DEFINED",
                "dimensions": dims,
                "timestamp": getattr(s, "timestamp", 0) * 1000,
                "properties": {"description": message},
            })
        if not events:
            return
        try:
            vhttp.post_json(
                f"{self.endpoint}/v2/event", events,
                headers={"X-SF-Token": self.api_key}, compress="gzip",
                timeout=self.timeout)
        except Exception as e:
            logger.error("signalfx event POST failed: %s", e)


def fetch_api_keys(api_endpoint: str, api_token: str,
                   timeout: float = 10.0) -> Dict[str, str]:
    """Page through the SignalFx org-token API and return {name: secret}
    (reference signalfx.go:422-445 fetchAPIKeys: limit-200 pages from
    /v2/token until an empty page)."""
    import json as _json

    tokens: Dict[str, str] = {}
    offset = 0
    while True:
        status, body = vhttp.get(
            f"{api_endpoint}/v2/token?limit=200&name=&offset={offset}",
            headers={"X-SF-Token": api_token,
                     "Content-Type": "application/json"},
            timeout=timeout)
        if status != 200:
            raise RuntimeError(
                f"signalfx api returned unknown response code: {status}")
        results = _json.loads(body).get("results")
        if not isinstance(results, list):
            raise RuntimeError(
                "unknown results structure returned from signalfx api")
        for r in results:
            if not isinstance(r, dict) or "name" not in r or "secret" not in r:
                raise RuntimeError("failed to extract token from result")
            tokens[str(r["name"])] = str(r["secret"])
        if not results:
            return tokens
        offset += 200


@register_metric_sink("signalfx")
def _factory(sink_config, server_config):
    c = sink_config.config
    if (c.get("dynamic_per_tag_api_keys_enable")
            and not c.get("dynamic_per_tag_api_keys_refresh_period")):
        # reference signalfx.go:286-291 refuses this combination
        raise ValueError(
            "per tag API keys are enabled, but the refresh period is unset")
    per_tag = {str(i.get("value", "")): str(i.get("api_key", ""))
               for i in (c.get("per_tag_api_keys", []) or [])}
    return SignalFxMetricSink(
        sink_config.name or "signalfx",
        api_key=str(c.get("api_key", "")),
        endpoint=c.get("endpoint_base", "https://ingest.signalfx.com"),
        hostname=server_config.hostname,
        hostname_tag=c.get("hostname_tag", "host"),
        vary_key_by=c.get("vary_key_by", ""),
        per_tag_tokens=per_tag,
        excluded_tags=c.get("excluded_tags", []) or [],
        drop_host_with_tag_key=c.get("drop_host_with_tag_key", ""),
        flush_max_per_body=int(c.get("flush_max_per_body", 0)),
        metric_tag_prefix_drops=c.get("metric_tag_prefix_drops", []) or [],
        preferred_vary_key_by=c.get("preferred_vary_key_by", ""),
        api_endpoint=c.get("endpoint_api", "https://api.signalfx.com"),
        dynamic_per_tag_tokens=bool(
            c.get("dynamic_per_tag_api_keys_enable", False)),
        dynamic_refresh_period_s=parse_duration(
            c.get("dynamic_per_tag_api_keys_refresh_period", 0) or 0))
