"""Falconer sink: spans streamed to a falconer trace store over gRPC.

Behavioral parity with reference sinks/falconer/falconer.go (193 LoC):
dial the falconer target and send each ingested span. The reference uses
falconer's generated client; here the SSFSpan protobuf is sent over a
unary-per-span grpc channel using a generic method path, with a
pluggable `sender` boundary so tests can capture spans without a live
falconer.

A copy of veneur_tpu/sinks/falconer.py. A failed dial raises from
start() where the JAX sink logs it and then drops every span."""

from __future__ import annotations

from typing import Callable, Optional

from veneur_tpu_torch.protocol import valid_trace
from veneur_tpu_torch.sinks import SpanSink, register_span_sink


class GrpcSpanSender:
    """Sends serialized SSFSpans over a grpc channel (route parity with
    the reference's generated client: /falconer.SpanSink/SendSpan,
    reference sinks/falconer/grpc_sink.pb.go:108, with the trace id in
    x-veneur-trace-id request metadata, falconer.go:134-138)."""

    METHOD = "/falconer.SpanSink/SendSpan"

    def __init__(self, target: str):
        import grpc
        self._channel = grpc.insecure_channel(target)
        self._send = self._channel.unary_unary(
            self.METHOD,
            request_serializer=lambda span: span.SerializeToString(),
            response_deserializer=lambda b: b)

    def __call__(self, span) -> None:
        self._send(span, timeout=5.0, metadata=(
            ("x-veneur-trace-id", format(span.trace_id, "x")),))

    def close(self) -> None:
        self._channel.close()


class FalconerSpanSink(SpanSink):
    def __init__(self, name: str, target: str = "",
                 sender: Optional[Callable] = None):
        self._name = name
        self.target = target
        self.sender = sender
        self.spans_handled = 0
        self.errors = 0

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "falconer"

    def start(self, server) -> None:
        super().start(server)
        if self.sender is None and self.target:
            self.sender = GrpcSpanSender(self.target)

    def ingest(self, span) -> None:
        if self.sender is None:
            return
        if not valid_trace(span):
            # reference validates before sending (falconer.go:130-132,
            # protocol/wire.go:82-88)
            return
        try:
            self.sender(span)
            self.spans_handled += 1
        except Exception:
            self.errors += 1

    def stop(self) -> None:
        close = getattr(self.sender, "close", None)
        if close is not None:
            close()


@register_span_sink("falconer")
def _factory(sink_config, server_config):
    c = sink_config.config
    return FalconerSpanSink(
        sink_config.name or "falconer",
        target=c.get("target", ""),
        sender=c.get("sender"))
