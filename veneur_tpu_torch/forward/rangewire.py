"""Scope-faithful metricpb encode and decode for reshard range segments
(torch port of veneur_tpu/forward/rangewire.py).

The reshard controller (parallel/reshard.py) writes every migrating row
into the range-segment WAL as ordinary metricpb wire: the bytes a
forward send carries, so the format needs no new schema and a stranded
segment reads with any metricpb tool. Two differences from the forward
path (forward/convert.py):

- **The scope is kept, not coerced.** The forward path stamps counters
  and gauges Global (they are remote data to their receiver) and the
  import coerces them back. A reshard moves a row between shards of the
  SAME store, where the scope is part of the row's identity (the intern
  key is (digest64 << 2) | scope): coercion would merge a MIXED counter
  into a new GLOBAL_ONLY row. Encode writes `meta.scope` as it is;
  decode reads `pbm.scope` as it is.

- **Local t-digest stats ride a sidecar.** The import merge never
  touches a digest's l* fields (a forwarded digest has no local
  samples). A migrating timer row's l* stats ARE local history, so they
  travel as one magic-prefixed JSON frame after the metric frames (f32
  -> f64 -> f32 is exact), and the controller replays them through
  ShardedHistoTable.merge_local_stats after the centroid merge.

The frames are byte for byte the JAX package's for the same rows.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from veneur_tpu_torch.forward import hllwire, llhistwire
from veneur_tpu_torch.forward.convert import (COMPRESSION, _SCOPE_FROM_PB,
                                        _SCOPE_TO_PB, metric_key_of_proto)
from veneur_tpu_torch.forward.protos import metric_pb2, tdigest_pb2
from veneur_tpu_torch.samplers import metrics as m
from veneur_tpu_torch.samplers.metrics import MetricScope, UDPMetric

# sidecar frame marker: cannot collide with a metricpb Metric (whose
# first field tag byte is 0x0A); only reshard segments are decoded here
LSTAT_MAGIC = b"VRS1"
LSTAT_FIELDS = ("lmin", "lmax", "lsum", "lweight", "lrecip")


# -- encode (one wire frame per migrating row) ------------------------------


def counter_to_wire(meta, value: float) -> bytes:
    # counter totals are integral by the apply kernel's trunc contract,
    # so the int64 proto field carries them exactly
    return metric_pb2.Metric(
        name=meta.name, tags=list(meta.tags), type=metric_pb2.Counter,
        scope=_SCOPE_TO_PB[meta.scope],
        counter=metric_pb2.CounterValue(
            value=int(round(float(value))))).SerializeToString()


def gauge_to_wire(meta, value: float) -> bytes:
    return metric_pb2.Metric(
        name=meta.name, tags=list(meta.tags), type=metric_pb2.Gauge,
        scope=_SCOPE_TO_PB[meta.scope],
        gauge=metric_pb2.GaugeValue(
            value=float(value))).SerializeToString()


def histogram_to_wire(meta, means, weights, dmin, dmax, drecip) -> bytes:
    nz = np.asarray(weights) > 0
    digest = tdigest_pb2.MergingDigestData(
        compression=COMPRESSION, min=float(dmin), max=float(dmax),
        reciprocalSum=float(drecip))
    for mean, weight in zip(np.asarray(means)[nz].tolist(),
                            np.asarray(weights)[nz].tolist()):
        digest.main_centroids.add(mean=mean, weight=weight)
    mtype = (metric_pb2.Timer if meta.wire_type == m.TIMER
             else metric_pb2.Histogram)
    return metric_pb2.Metric(
        name=meta.name, tags=list(meta.tags), type=mtype,
        scope=_SCOPE_TO_PB[meta.scope],
        histogram=metric_pb2.HistogramValue(
            t_digest=digest)).SerializeToString()


def llhist_to_wire(meta, bins) -> bytes:
    return metric_pb2.Metric(
        name=meta.name, tags=list(meta.tags), type=metric_pb2.LLHist,
        scope=_SCOPE_TO_PB[meta.scope],
        llhist=metric_pb2.LLHistValue(
            bins=llhistwire.marshal(bins))).SerializeToString()


def set_to_wire(meta, registers) -> bytes:
    return metric_pb2.Metric(
        name=meta.name, tags=list(meta.tags), type=metric_pb2.Set,
        scope=_SCOPE_TO_PB[meta.scope],
        set=metric_pb2.SetValue(
            hyper_log_log=hllwire.marshal(
                np.asarray(registers, np.uint8)))).SerializeToString()


def lstat_sidecar(stats: Dict[str, List[float]]) -> bytes:
    """One sidecar frame for a segment's histogram rows: per-field f64
    lists ALIGNED with the order of the segment's histogram frames."""
    return LSTAT_MAGIC + json.dumps(
        {k: [float(x) for x in stats[k]] for k in LSTAT_FIELDS}).encode()


# -- decode -----------------------------------------------------------------


@dataclass
class DecodedBatch:
    """Per-family replay batches from one range segment, in the shapes
    the family merge_batch methods take."""

    counter_stubs: List[UDPMetric] = field(default_factory=list)
    counter_values: List[float] = field(default_factory=list)
    gauge_stubs: List[UDPMetric] = field(default_factory=list)
    gauge_values: List[float] = field(default_factory=list)
    histo_stubs: List[UDPMetric] = field(default_factory=list)
    histo_means: List[np.ndarray] = field(default_factory=list)
    histo_weights: List[np.ndarray] = field(default_factory=list)
    histo_mins: List[float] = field(default_factory=list)
    histo_maxs: List[float] = field(default_factory=list)
    histo_recips: List[float] = field(default_factory=list)
    llhist_stubs: List[UDPMetric] = field(default_factory=list)
    llhist_bins: List[np.ndarray] = field(default_factory=list)
    set_stubs: List[UDPMetric] = field(default_factory=list)
    set_regs: List[np.ndarray] = field(default_factory=list)
    # l* sidecar arrays, aligned with histo_stubs; None when absent
    lstats: Optional[Dict[str, List[float]]] = None
    metrics: int = 0
    parse_errors: int = 0


def _stub_of(pbm, key, h32: int, h64: int,
             tags: list) -> UDPMetric:
    return UDPMetric(
        key=key, digest=h32, digest64=h64, tags=list(tags),
        # verbatim — a reshard moves rows within one store, where scope
        # is part of row identity (no import_scope coercion)
        scope=_SCOPE_FROM_PB.get(pbm.scope, MetricScope.MIXED))


def decode_segment(blobs: List[bytes]) -> DecodedBatch:
    """Decode one range segment's frames back into per-family replay
    batches. Tolerant: an unparseable frame is counted, not fatal — the
    WAL exists to save data through crashes, and one corrupt frame must
    not strand its segment's remaining rows."""
    out = DecodedBatch()
    for blob in blobs:
        if blob.startswith(LSTAT_MAGIC):
            try:
                out.lstats = {
                    k: [float(x) for x in v]
                    for k, v in json.loads(
                        blob[len(LSTAT_MAGIC):]).items()}
            except (ValueError, AttributeError):
                out.parse_errors += 1
            continue
        pbm = metric_pb2.Metric()
        try:
            pbm.ParseFromString(blob)
            key, h32, h64, tags = metric_key_of_proto(pbm)
        except Exception:
            out.parse_errors += 1
            continue
        which = pbm.WhichOneof("value")
        stub = _stub_of(pbm, key, h32, h64, tags)
        if which == "counter":
            out.counter_stubs.append(stub)
            out.counter_values.append(float(pbm.counter.value))
        elif which == "gauge":
            out.gauge_stubs.append(stub)
            out.gauge_values.append(float(pbm.gauge.value))
        elif which == "histogram":
            d = pbm.histogram.t_digest
            out.histo_stubs.append(stub)
            out.histo_means.append(np.fromiter(
                (c.mean for c in d.main_centroids), np.float64))
            out.histo_weights.append(np.fromiter(
                (c.weight for c in d.main_centroids), np.float64))
            out.histo_mins.append(float(d.min))
            out.histo_maxs.append(float(d.max))
            out.histo_recips.append(float(d.reciprocalSum))
        elif which == "llhist":
            out.llhist_stubs.append(stub)
            out.llhist_bins.append(llhistwire.unmarshal(pbm.llhist.bins))
        elif which == "set":
            regs, _p = hllwire.unmarshal(pbm.set.hyper_log_log)
            out.set_stubs.append(stub)
            out.set_regs.append(np.asarray(regs))
        else:
            out.parse_errors += 1
            continue
        out.metrics += 1
    return out
