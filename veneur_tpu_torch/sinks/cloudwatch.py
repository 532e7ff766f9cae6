"""CloudWatch sink: PutMetricData.

Behavioral parity with reference sinks/cloudwatch/cloudwatch.go (174 LoC):
InterMetrics become CloudWatch MetricDatum entries (dimensions from tags,
20 datums per request — the API cap the reference also chunks to) POSTed
to the monitoring Query API as form-encoded PutMetricData calls, signed
with SigV4 when credentials are configured (the reference gets signing
from the AWS SDK; here it is a ~40-line stdlib implementation). Tests
point `endpoint` at a local fake and skip signing.

Copied from veneur_tpu/sinks/cloudwatch.py.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import logging
import urllib.parse
from typing import Dict, List, Optional, Tuple

from veneur_tpu_torch.config import parse_duration
from veneur_tpu_torch.samplers.metrics import InterMetric, MetricType
from veneur_tpu_torch.sinks import MetricSink, register_metric_sink
from veneur_tpu_torch.util import http as vhttp

logger = logging.getLogger("veneur_tpu_torch.sinks.cloudwatch")

MAX_DATUMS_PER_CALL = 20  # PutMetricData API limit


def sigv4_headers(method: str, url: str, body: bytes, region: str,
                  access_key: str, secret_key: str,
                  service: str = "monitoring",
                  now: Optional[datetime.datetime] = None) -> Dict[str, str]:
    """Minimal AWS Signature Version 4 for a form-encoded POST."""
    parsed = urllib.parse.urlparse(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date_stamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(body).hexdigest()
    canonical_headers = (f"host:{parsed.netloc}\n"
                         f"x-amz-date:{amz_date}\n")
    signed_headers = "host;x-amz-date"
    canonical_request = "\n".join([
        method, parsed.path or "/", parsed.query, canonical_headers,
        signed_headers, payload_hash])
    scope = f"{date_stamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hmac(f"AWS4{secret_key}".encode(), date_stamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()
    return {
        "X-Amz-Date": amz_date,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"),
    }


DEFAULT_STANDARD_UNIT_TAG = "cloudwatch_standard_unit"  # cloudwatch.go:24


def datum_params(index: int, m: InterMetric,
                 standard_unit_tag: str = DEFAULT_STANDARD_UNIT_TAG,
                 default_unit: str = "None") -> Dict[str, str]:
    """Flatten one MetricDatum into Query-API form params. A tag named
    `standard_unit_tag` supplies the datum's Unit (falling back to
    `default_unit`) and is excluded from dimensions; tags without a
    colon are dropped as illegal (reference cloudwatch.go:137-152)."""
    unit = default_unit
    dims = []
    for tag in m.tags:
        k, sep, v = tag.partition(":")
        if not sep:
            continue  # drop illegal tag
        if k == standard_unit_tag:
            unit = v or default_unit
            continue
        # the API rejects empty dimension values; valued-but-empty tags
        # keep the historical "true" placeholder
        dims.append((k, v or "true"))
    p = {f"MetricData.member.{index}.MetricName": m.name,
         f"MetricData.member.{index}.Value": repr(float(m.value)),
         f"MetricData.member.{index}.Unit": unit,
         f"MetricData.member.{index}.Timestamp":
             datetime.datetime.fromtimestamp(
                 m.timestamp, datetime.timezone.utc).strftime(
                 "%Y-%m-%dT%H:%M:%SZ")}
    for di, (k, v) in enumerate(dims[:30], start=1):  # API cap: 30 dims
        p[f"MetricData.member.{index}.Dimensions.member.{di}.Name"] = k
        p[f"MetricData.member.{index}.Dimensions.member.{di}.Value"] = v
    return p


class CloudWatchMetricSink(MetricSink):
    def __init__(self, name: str, endpoint: str, namespace: str,
                 region: str = "", credentials: Tuple[str, str] = ("", ""),
                 standard_unit_tag: str = DEFAULT_STANDARD_UNIT_TAG,
                 default_unit: str = "None",
                 timeout: float = 10.0, disable_retries: bool = False):
        self._name = name
        self.endpoint = endpoint
        self.namespace = namespace
        self.region = region
        self.credentials = credentials
        self.standard_unit_tag = standard_unit_tag
        self.default_unit = default_unit
        self.timeout = timeout
        # aws_disable_retries maps to the SDK's NopRetryer
        # (cloudwatch.go:123-125); default is one retry pass
        self.max_attempts = 1 if disable_retries else 3

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "cloudwatch"

    def flush(self, metrics: List[InterMetric]) -> None:
        datums = [m for m in metrics if m.type != MetricType.STATUS]
        for i in range(0, len(datums), MAX_DATUMS_PER_CALL):
            chunk = datums[i:i + MAX_DATUMS_PER_CALL]
            params = {"Action": "PutMetricData", "Version": "2010-08-01",
                      "Namespace": self.namespace}
            for j, m in enumerate(chunk, start=1):
                params.update(datum_params(
                    j, m, self.standard_unit_tag, self.default_unit))
            body = urllib.parse.urlencode(params).encode()
            headers = {}
            if self.credentials[0]:
                headers = sigv4_headers(
                    "POST", self.endpoint, body, self.region,
                    *self.credentials)
            for attempt in range(1, self.max_attempts + 1):
                try:
                    vhttp.post(
                        self.endpoint, body,
                        content_type="application/x-www-form-urlencoded",
                        headers=headers, timeout=self.timeout)
                    break
                except Exception as e:
                    if (isinstance(e, vhttp.HTTPError)
                            and 400 <= e.status < 500):
                        # non-retryable: an identical resend is doomed
                        logger.error(
                            "cloudwatch PutMetricData rejected (%d): %s",
                            e.status, e)
                        break
                    if attempt == self.max_attempts:
                        logger.error(
                            "cloudwatch PutMetricData failed: %s", e)


@register_metric_sink("cloudwatch")
def _factory(sink_config, server_config):
    c = sink_config.config
    region = c.get("aws_region", "us-east-1")
    return CloudWatchMetricSink(
        sink_config.name or "cloudwatch",
        endpoint=(c.get("cloudwatch_endpoint", "")
                  or c.get("aws_endpoint",
                           f"https://monitoring.{region}.amazonaws.com/")),
        namespace=c.get("cloudwatch_namespace", "veneur"),
        region=region,
        credentials=(str(c.get("aws_access_key_id", "")),
                     str(c.get("aws_secret_access_key", ""))),
        standard_unit_tag=c.get("cloudwatch_standard_unit_tag_name",
                                DEFAULT_STANDARD_UNIT_TAG),
        default_unit=c.get("cloudwatch_standard_unit", "None"),
        timeout=parse_duration(c.get("remote_timeout", 0) or 0) or 10.0,
        disable_retries=bool(c.get("aws_disable_retries", False)))
