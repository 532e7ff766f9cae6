"""Kafka sink: metrics to Kafka topics.

Behavioral parity with reference sinks/kafka/kafka.go (449 LoC): an async
producer publishes each flushed InterMetric (and/or each ingested span)
to configured topics, encoded as JSON or protobuf, with optional
partition keying by metric name and span sampling by trace id.

The reference embeds sarama; here the producer is a small pluggable
transport (`Producer`) so the sink logic — encoding, topics, sampling —
is identical whether backed by a real client (`kafka-python` if
installed), a spool file, or the in-memory producer tests use.

Copied from veneur_tpu/sinks/kafka.py without its span sink
(KafkaSpanSink and the span encoders), which arrives with the SSF plane.
"""

from __future__ import annotations

import json
import logging
import random
import threading
from typing import Any, List, Optional

from veneur_tpu_torch.samplers.metrics import InterMetric, MetricType
from veneur_tpu_torch.sinks import MetricSink, register_metric_sink

logger = logging.getLogger("veneur_tpu_torch.sinks.kafka")


class Producer:
    """Transport boundary: send(topic, key, value) then flush()."""

    def send(self, topic: str, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def flush(self) -> None:  # noqa: B027
        pass

    def close(self) -> None:  # noqa: B027
        pass


class InMemoryProducer(Producer):
    """Test producer: records (topic, key, value) tuples."""

    def __init__(self):
        self.messages: List[tuple] = []
        self._lock = threading.Lock()

    def send(self, topic: str, key: bytes, value: bytes) -> None:
        with self._lock:
            self.messages.append((topic, key, value))


class ProducerConfig:
    """Producer tuning with the reference's sarama semantics
    (sinks/kafka/kafka.go:142-187): ack level all/none/local,
    hash-or-random partitioning, bounded retries, and byte/message/time
    flush triggers."""

    def __init__(self, require_acks: str = "all", partitioner: str = "hash",
                 retry_max: int = 3, buffer_bytes: int = 0,
                 buffer_messages: int = 0, buffer_frequency_s: float = 0.0):
        if require_acks not in ("all", "none", "local"):
            logger.warning("unknown ack requirement %r, defaulting to all",
                           require_acks)
            require_acks = "all"
        if partitioner not in ("hash", "random"):
            partitioner = "hash"
        self.require_acks = require_acks
        self.partitioner = partitioner
        self.retry_max = retry_max
        self.buffer_bytes = buffer_bytes
        self.buffer_messages = buffer_messages
        self.buffer_frequency_s = buffer_frequency_s

    @classmethod
    def from_config(cls, c: dict, prefix: str) -> "ProducerConfig":
        """Reads the reference's yaml keys: metric_require_acks /
        span_require_acks, partitioner, retry_max, metric_buffer_bytes /
        metric_buffer_messages / metric_buffer_frequency and the span_
        equivalents (span_buffer_bytes, span_buffer_frequency,
        span_buffer_mesages — the reference's spelling)."""
        from veneur_tpu_torch.config import parse_duration
        freq = c.get(f"{prefix}_buffer_frequency", 0)
        return cls(
            require_acks=c.get(f"{prefix}_require_acks", "all"),
            partitioner=c.get("partitioner", "hash"),
            retry_max=int(c.get("retry_max", c.get("retries", 3))),
            buffer_bytes=int(c.get(f"{prefix}_buffer_bytes", 0)),
            buffer_messages=int(c.get(f"{prefix}_buffer_messages",
                                      # reference spells this one
                                      # "span_buffer_mesages" (sic)
                                      c.get(f"{prefix}_buffer_mesages", 0))),
            buffer_frequency_s=parse_duration(freq) if freq else 0.0)

    def kafka_python_kwargs(self) -> dict:
        kw: dict = {
            "acks": {"all": "all", "none": 0, "local": 1}[self.require_acks],
            "retries": self.retry_max,
        }
        if self.buffer_bytes:
            kw["batch_size"] = self.buffer_bytes
        if self.buffer_frequency_s:
            kw["linger_ms"] = int(self.buffer_frequency_s * 1000)
        if self.partitioner == "random":
            def _random_partitioner(key, all_parts, available):
                return random.choice(available or all_parts)

            kw["partitioner"] = _random_partitioner
        return kw


class KafkaPythonProducer(Producer):
    """Real transport via kafka-python, when available."""

    def __init__(self, brokers: str, config: Optional[ProducerConfig] = None):
        from kafka import KafkaProducer  # gated import
        self._cfg = config or ProducerConfig()
        self._p = KafkaProducer(bootstrap_servers=brokers.split(","),
                                **self._cfg.kafka_python_kwargs())

    def send(self, topic: str, key: bytes, value: bytes) -> None:
        # sarama's Flush.Messages (buffer_messages) is an async batching
        # trigger, not a blocking flush — kafka-python's own batch_size/
        # linger_ms batching already plays that role, and even a
        # 100ms-bounded flush() here would insert caller-thread stalls
        # into the span/metric flush path whenever the broker is slow.
        # Delivery is guaranteed by the interval flush() below.
        self._p.send(topic, key=key or None, value=value)

    def flush(self) -> None:
        self._p.flush(timeout=10)

    def close(self) -> None:
        self._p.close()


def make_producer(brokers: str,
                  config: Optional[ProducerConfig] = None,
                  ) -> Optional[Producer]:
    try:
        return KafkaPythonProducer(brokers, config)
    except ImportError:
        logger.error("kafka-python not installed; kafka sink will drop "
                     "(configure an explicit producer for tests)")
        return None
    except Exception as e:
        logger.error("kafka producer connect failed: %s", e)
        return None


def encode_metric_json(m: InterMetric) -> bytes:
    return json.dumps({
        "name": m.name,
        "timestamp": m.timestamp,
        "value": m.value,
        "tags": m.tags,
        "type": m.type.name.lower(),
        "hostname": m.hostname,
    }, separators=(",", ":")).encode()


class KafkaMetricSink(MetricSink):
    def __init__(self, name: str, producer: Optional[Producer],
                 check_topic: str = "", event_topic: str = "",
                 metric_topic: str = "", partition_by_name: bool = True):
        self._name = name
        self.producer = producer
        self.metric_topic = metric_topic
        self.check_topic = check_topic
        self.event_topic = event_topic
        self.partition_by_name = partition_by_name

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "kafka"

    def flush(self, metrics: List[InterMetric]) -> None:
        if self.producer is None:
            return
        sent = False
        for m in metrics:
            # service checks route to check_topic (reference
            # sinks/kafka/kafka.go FlushCheck split), everything else to
            # metric_topic
            topic = (self.check_topic if m.type == MetricType.STATUS
                     else self.metric_topic)
            if not topic:
                continue
            key = m.name.encode() if self.partition_by_name else b""
            self.producer.send(topic, key, encode_metric_json(m))
            sent = True
        if sent:
            self.producer.flush()

    def flush_other_samples(self, samples) -> None:
        if self.producer is None or not self.event_topic:
            return
        for s in samples:
            body = json.dumps({
                "name": getattr(s, "name", ""),
                "message": getattr(s, "message", ""),
                "timestamp": getattr(s, "timestamp", 0),
                "tags": dict(getattr(s, "tags", {}) or {}),
            }, separators=(",", ":")).encode()
            self.producer.send(self.event_topic, b"", body)
        self.producer.flush()

    def stop(self) -> None:
        if self.producer is not None:
            self.producer.close()


@register_metric_sink("kafka")
def _metric_factory(sink_config, server_config):
    c = sink_config.config
    producer: Any = c.get("producer")  # tests inject one
    if producer is None:
        producer = make_producer(c.get("broker", "localhost:9092"),
                                 ProducerConfig.from_config(c, "metric"))
    return KafkaMetricSink(
        sink_config.name or "kafka",
        producer=producer,
        metric_topic=c.get("metric_topic", ""),
        check_topic=c.get("check_topic", ""),
        event_topic=c.get("event_topic", ""),
        partition_by_name=bool(c.get("partition_by_name", True)))
