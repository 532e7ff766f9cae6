"""Series-name helpers of the self-trace plane (the pure functions of
veneur_tpu/trace/store.py:39-60, copied). The Prometheus and Cortex
sinks use them to attach exemplars; the stores themselves (TraceStore,
ExemplarStore, SelfTracePlane) arrive with the tracing plane, and until
then a port server has no exemplar source."""

from __future__ import annotations

# suffixes a flushed series name grows on top of the base metric name;
# exemplar lookups strip them so `foo.bucket{le:...}` / the observatory's
# `pipeline.sample_age.p99` row find the exemplar stored under the base
SERIES_SUFFIXES = (".bucket", ".sum", ".count", ".p50", ".p99", ".max")


def exemplar_base(name: str) -> str:
    """The base metric name an exemplar is stored under — the series
    name with any known flush/observatory suffix stripped."""
    for suffix in SERIES_SUFFIXES:
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def trace_id_hex(trace_id: int) -> str:
    return format(int(trace_id), "x") if trace_id else ""
