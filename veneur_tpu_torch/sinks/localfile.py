"""Local-file sink: appends flushed metrics as TSV lines
(reference sinks/localfile/localfile.go + util/csv.go column layout).

Copied from veneur_tpu/sinks/localfile.py.
"""

from __future__ import annotations

import csv
import logging
import time

from veneur_tpu_torch.sinks import MetricSink, register_metric_sink

logger = logging.getLogger("veneur_tpu_torch.sinks.localfile")

# TSV column layout, matching the reference's S3/localfile encoder
# (util/csv.go): name, tags, type, hostname, timestamp, value, interval
HEADERS = ["Name", "Tags", "MetricType", "Hostname", "Timestamp", "Value",
           "Partition", "VeneurHostname", "Interval"]


class LocalFileSink(MetricSink):
    def __init__(self, name: str, path: str, hostname: str, interval: float,
                 delimiter: str = "\t"):
        self._name = name
        self.path = path
        self.hostname = hostname
        self.interval = interval
        self.delimiter = delimiter

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "localfile"

    def flush(self, metrics) -> None:
        if not metrics:
            return
        try:
            with open(self.path, "a", newline="") as f:
                w = csv.writer(f, delimiter=self.delimiter)
                partition = time.strftime("%Y%m%d")
                for metric in metrics:
                    w.writerow([
                        metric.name, ",".join(metric.tags), metric.type.name.lower(),
                        metric.hostname, metric.timestamp, metric.value,
                        partition, self.hostname, int(self.interval)])
        except OSError as e:
            logger.error("could not flush to %s: %s", self.path, e)


@register_metric_sink("localfile")
def _factory(sink_config, server_config):
    return LocalFileSink(
        sink_config.name or "localfile",
        path=sink_config.config.get("flush_file", "/tmp/veneur-tpu.tsv"),
        hostname=server_config.hostname,
        interval=server_config.interval,
        delimiter=sink_config.config.get("delimiter", "\t"))
