"""SSF (Sensor Sensibility Format): the protobuf span + sample schema and
its constructor helpers (a copy of veneur_tpu/ssf/__init__.py).

Parity with the reference ssf package (reference ssf/sample.proto:9-131,
ssf/samples.go): SSFSample/SSFSpan protos plus the `count`/`gauge`/
`histogram`/`timing`/`set_sample`/`status` constructors and
`randomly_sample`. Where the JAX package rolls `randomly_sample` on the
module-global `random`, the port takes the generator from its caller.
"""

from __future__ import annotations

import random
import time as _time
from typing import Dict, List, Optional, Sequence

from veneur_tpu_torch.ssf.protos import ssf_pb2

SSFSample = ssf_pb2.SSFSample
SSFSpan = ssf_pb2.SSFSpan

COUNTER = SSFSample.COUNTER
GAUGE = SSFSample.GAUGE
HISTOGRAM = SSFSample.HISTOGRAM
SET = SSFSample.SET
STATUS = SSFSample.STATUS

OK = SSFSample.OK
WARNING = SSFSample.WARNING
CRITICAL = SSFSample.CRITICAL
UNKNOWN = SSFSample.UNKNOWN


def _mk(metric, name: str, value: float = 0.0,
        tags: Optional[Dict[str, str]] = None, unit: str = "",
        message: str = "", status=OK, timestamp: Optional[int] = None,
        sample_rate: float = 1.0) -> ssf_pb2.SSFSample:
    s = ssf_pb2.SSFSample(
        metric=metric, name=name, value=value, unit=unit,
        message=message, status=status, sample_rate=sample_rate,
        timestamp=timestamp if timestamp is not None
        else int(_time.time() * 1e9))
    if tags:
        for k, v in tags.items():
            s.tags[k] = v
    return s


def count(name: str, value: float,
          tags: Optional[Dict[str, str]] = None) -> ssf_pb2.SSFSample:
    return _mk(COUNTER, name, value, tags)


def gauge(name: str, value: float,
          tags: Optional[Dict[str, str]] = None) -> ssf_pb2.SSFSample:
    return _mk(GAUGE, name, value, tags)


def histogram(name: str, value: float,
              tags: Optional[Dict[str, str]] = None,
              unit: str = "") -> ssf_pb2.SSFSample:
    return _mk(HISTOGRAM, name, value, tags, unit=unit)


def timing(name: str, duration_s: float, resolution_s: float = 1e-9,
           tags: Optional[Dict[str, str]] = None) -> ssf_pb2.SSFSample:
    """A histogram expressing a duration in units of `resolution_s`
    (reference ssf/samples.go Timing: duration/resolution, unit name)."""
    unit = {1e-9: "ns", 1e-6: "us", 1e-3: "ms", 1.0: "s"}.get(
        resolution_s, "")
    return _mk(HISTOGRAM, name, duration_s / resolution_s, tags, unit=unit)


def set_sample(name: str, member: str,
               tags: Optional[Dict[str, str]] = None) -> ssf_pb2.SSFSample:
    return _mk(SET, name, 0.0, tags, message=member)


def status(name: str, state, message: str = "",
           tags: Optional[Dict[str, str]] = None) -> ssf_pb2.SSFSample:
    return _mk(STATUS, name, 0.0, tags, message=message, status=state)


def randomly_sample(rng: random.Random, rate: float,
                    *samples: ssf_pb2.SSFSample) -> List[ssf_pb2.SSFSample]:
    """Keep each sample independently with probability `rate` (one
    `rng.random()` roll each), multiplying the survivor's existing
    sample_rate by `rate` so pre-sampled values keep scaling correctly
    (reference ssf/samples.go:134-154 RandomlySample)."""
    out: List[ssf_pb2.SSFSample] = []
    for s in samples:
        if rng.random() <= rate:
            if 0 < rate <= 1:
                s.sample_rate = (s.sample_rate or 1.0) * rate
            out.append(s)
    return out


def span_from_samples(samples: Sequence[ssf_pb2.SSFSample]) -> ssf_pb2.SSFSpan:
    """Wrap bare samples in a non-trace carrier span (ssf/samples.go
    Samples)."""
    span = ssf_pb2.SSFSpan()
    span.metrics.extend(samples)
    return span
