"""S3 sink: per-flush TSV object uploads.

Behavioral parity with reference sinks/s3/s3.go (172 LoC) + util/csv.go:
each flush encodes every InterMetric as one TSV row (same column layout
as the localfile sink), gzips it, and uploads to
s3://<bucket>/<hostname>/<timestamp>.tsv.gz. The uploader is a pluggable
boundary (the reference takes an s3iface; tests inject a fake).

Copied from veneur_tpu/sinks/s3.py.
"""

from __future__ import annotations

import csv
import gzip
import io
import logging
import time
from typing import List, Optional

from veneur_tpu_torch.samplers.metrics import InterMetric
from veneur_tpu_torch.sinks import MetricSink, register_metric_sink
from veneur_tpu_torch.sinks.localfile import HEADERS

logger = logging.getLogger("veneur_tpu_torch.sinks.s3")


class Uploader:
    def upload(self, bucket: str, key: str, body: bytes) -> None:
        raise NotImplementedError


class Boto3Uploader(Uploader):
    def __init__(self, region: str = "", access_key_id: str = "",
                 secret_access_key: str = ""):
        import boto3  # gated import
        # explicit static credentials when configured (reference
        # s3.go:67-75), else the SDK's default chain
        kw = {}
        if access_key_id:
            kw = {"aws_access_key_id": access_key_id,
                  "aws_secret_access_key": secret_access_key}
        self._client = boto3.client("s3", region_name=region or None, **kw)

    def upload(self, bucket: str, key: str, body: bytes) -> None:
        self._client.put_object(Bucket=bucket, Key=key, Body=body)


class InMemoryUploader(Uploader):
    """Test uploader: records (bucket, key, body)."""

    def __init__(self):
        self.objects: List[tuple] = []

    def upload(self, bucket: str, key: str, body: bytes) -> None:
        self.objects.append((bucket, key, body))


def encode_tsv(metrics: List[InterMetric], hostname: str,
               interval: float) -> bytes:
    buf = io.StringIO()
    w = csv.writer(buf, delimiter="\t")
    partition = time.strftime("%Y%m%d")
    for m in metrics:
        w.writerow([m.name, ",".join(m.tags), m.type.name.lower(),
                    m.hostname, m.timestamp, m.value, partition, hostname,
                    int(interval)])
    return buf.getvalue().encode()


class S3MetricSink(MetricSink):
    def __init__(self, name: str, uploader: Optional[Uploader], bucket: str,
                 hostname: str, interval: float):
        self._name = name
        self.uploader = uploader
        self.bucket = bucket
        self.hostname = hostname
        self.interval = interval

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "s3"

    def flush(self, metrics: List[InterMetric]) -> None:
        if self.uploader is None or not metrics:
            return
        body = gzip.compress(
            encode_tsv(metrics, self.hostname, self.interval))
        key = f"{self.hostname}/{int(time.time())}.tsv.gz"
        try:
            self.uploader.upload(self.bucket, key, body)
        except Exception as e:
            logger.error("s3 upload of %s failed: %s", key, e)


@register_metric_sink("s3")
def _factory(sink_config, server_config):
    c = sink_config.config
    uploader = c.get("uploader")  # tests inject one
    if uploader is None:
        try:
            uploader = Boto3Uploader(
                c.get("region", ""),
                access_key_id=str(c.get("access_key_id", "")),
                secret_access_key=str(c.get("secret_access_key", "")))
        except Exception as e:
            logger.error("s3 uploader unavailable: %s", e)
            uploader = None
    return S3MetricSink(
        sink_config.name or "s3",
        uploader=uploader,
        bucket=c.get("s3_bucket", "") or c.get("bucket", ""),
        hostname=server_config.hostname,
        interval=server_config.interval)
