"""gRPC ingest plane: DogStatsD packets and SSF spans over gRPC (a copy
of veneur_tpu/core/grpc_ingest.py).

Parity with the reference's GrpcMetricsSource (reference
networking.go:325-352 StartGRPC / SendPacket / SendSpan, service
definitions protocol/dogstatsd/grpc.proto and ssf/grpc.proto): one gRPC
server per `grpc_listen_addresses` entry exposing

  dogstatsd.DogstatsdGRPC/SendPacket  (DogstatsdPacket{packetBytes})
  ssf.SSFGRPC/SendSpan                (ssf.SSFSpan)

Packets re-enter the normal parse path (the native batch parser
included); spans go onto the span channel, counted as SSF packets.
"""

from __future__ import annotations

import logging
from concurrent import futures
from typing import Optional

import grpc

from veneur_tpu_torch.core.protos import dogstatsd_pb2
from veneur_tpu_torch.ssf.protos import ssf_pb2

logger = logging.getLogger("veneur_tpu_torch.grpc_ingest")

_EMPTY = dogstatsd_pb2.Empty()


class GrpcIngestServer:
    """Serves both ingest services on one port (like the reference, which
    registers both on the same grpc.Server). A failed bind raises."""

    def __init__(self, server, address: str = "127.0.0.1:0",
                 max_workers: int = 4):
        self._server = server
        self._grpc = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        dogstatsd = grpc.method_handlers_generic_handler(
            "dogstatsd.DogstatsdGRPC", {
                "SendPacket": grpc.unary_unary_rpc_method_handler(
                    self._send_packet,
                    request_deserializer=(
                        dogstatsd_pb2.DogstatsdPacket.FromString),
                    response_serializer=(
                        dogstatsd_pb2.Empty.SerializeToString)),
            })
        ssf_svc = grpc.method_handlers_generic_handler(
            "ssf.SSFGRPC", {
                "SendSpan": grpc.unary_unary_rpc_method_handler(
                    self._send_span,
                    request_deserializer=ssf_pb2.SSFSpan.FromString,
                    response_serializer=(
                        dogstatsd_pb2.Empty.SerializeToString)),
            })
        self._grpc.add_generic_rpc_handlers((dogstatsd, ssf_svc))
        self._host = address.rsplit(":", 1)[0] or "127.0.0.1"
        self.port = self._grpc.add_insecure_port(address)
        if self.port == 0:
            raise RuntimeError(f"could not bind gRPC ingest to {address}")

    @property
    def address(self) -> str:
        # a wildcard bind is reachable over loopback; report it that way
        host = "127.0.0.1" if self._host in ("0.0.0.0", "[::]", "::") \
            else self._host
        return f"{host}:{self.port}"

    def start(self) -> None:
        self._grpc.start()
        logger.info("listening for gRPC dogstatsd/SSF on %s", self.address)

    def stop(self, grace: Optional[float] = 0.5) -> None:
        self._grpc.stop(grace).wait()

    # -- handlers ---------------------------------------------------------

    def _send_packet(self, request, context):
        self._server.handle_packet_batch([request.packetBytes])
        return _EMPTY

    def _send_span(self, request, context):
        self._server.handle_ssf_span(request)
        return _EMPTY
