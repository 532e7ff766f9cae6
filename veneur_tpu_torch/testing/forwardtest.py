"""In-process gRPC Forward server for tests and the soaks: collects
forwarded metrics through a callback (pattern from reference
internal/forwardtest/server.go; a copy of veneur_tpu/testing/forwardtest.py
with the port's protos)."""

from __future__ import annotations

from concurrent import futures
from typing import Callable, List

import grpc

from veneur_tpu_torch.forward.protos import metric_pb2


class ForwardTestServer:
    def __init__(self, handler: Callable[[List[metric_pb2.Metric]], None],
                 address: str = "127.0.0.1:0"):
        # a fixed `address` lets kill/restore tests re-bind the SAME
        # port a stopped instance held (grpc listeners use SO_REUSEADDR),
        # so a reconnecting client/destination finds the "restarted node"
        self._handler = handler
        # per-call invocation metadata, as dicts — tracing tests assert
        # the x-veneur-* sidecars ride every transport path here
        self.call_metadata: List[dict] = []
        self._grpc = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        h = grpc.method_handlers_generic_handler("forwardrpc.Forward", {
            "SendMetricsV2": grpc.stream_unary_rpc_method_handler(
                self._recv,
                request_deserializer=metric_pb2.Metric.FromString,
                response_serializer=lambda _: b""),
        })
        self._grpc.add_generic_rpc_handlers((h,))
        self.port = self._grpc.add_insecure_port(address)
        if self.port == 0:
            raise RuntimeError(f"could not bind test server to {address}")

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def _recv(self, request_iterator, ctx):
        try:
            self.call_metadata.append(
                dict(ctx.invocation_metadata() or ()))
        except Exception:
            pass
        self._handler(list(request_iterator))
        return b""

    def start(self) -> None:
        self._grpc.start()

    def stop(self) -> None:
        self._grpc.stop(0.2)
