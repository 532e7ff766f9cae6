"""Forward client: sends a local server's mergeable state to the global
tier once per interval (port of the core of veneur_tpu/forward/client.py,
reference flusher.go:516-591).

Each interval's payload carries one idempotency token. It goes out as one
unary /forwardrpc.Forward/SendMetrics MetricList body first; an importer
that refuses V1 (UNIMPLEMENTED, RESOURCE_EXHAUSTED) gets the same batch
over the SendMetricsV2 stream, and the client stays on V2 from then on.
The interval is the deadline. A failed send is counted in the errors_*
stats and logged, and the interval's state is dropped: retry, circuit
breaker, carryover, spool and WAL are a later slice.
"""

from __future__ import annotations

import logging
import uuid
from typing import Dict, Optional

import grpc

from veneur_tpu_torch.core.flusher import ForwardableState
from veneur_tpu_torch.forward.convert import forwardable_to_wire
from veneur_tpu_torch.forward.wire import (_serialize_metric,
                                           decode_flow_counts, send_batch,
                                           token_metadata)

logger = logging.getLogger("veneur_tpu_torch.forward.client")

# a V1 body scales with the key count (tens of MB at tens of thousands of
# digests): far past gRPC's 4 MB default
MAX_MESSAGE_BYTES = 256 << 20
# structural V1 refusals that pin the client to the V2 stream
_PIN_CODES = (grpc.StatusCode.UNIMPLEMENTED,
              grpc.StatusCode.RESOURCE_EXHAUSTED)


def _raw(b):
    return b


class ForwardClient:
    """gRPC client for /forwardrpc.Forward on the generic channel API (no
    generated stubs). `stats` holds forwarded_total, the errors_* counts,
    and the receiver's cumulative FlowCounts (remote_received,
    remote_merged, remote_duplicates); `last_flow` is the last send's
    decoded FlowCounts (None from a peer that answers Empty)."""

    def __init__(self, address: str, deadline: float = 10.0):
        self.address = address
        self.deadline = deadline
        # token = client identity + interval sequence
        self._token_id = uuid.uuid4().hex[:12]
        self._token_seq = 0
        self._channel = grpc.insecure_channel(
            address, options=[
                ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
                ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                # a restarted global stays dialable within an interval
                ("grpc.initial_reconnect_backoff_ms", 250),
                ("grpc.min_reconnect_backoff_ms", 250),
                ("grpc.max_reconnect_backoff_ms", 2000)])
        self._send_v2 = self._channel.stream_unary(
            "/forwardrpc.Forward/SendMetricsV2",
            request_serializer=_serialize_metric,
            response_deserializer=_raw)
        # the V1 body is assembled from already-serialized metrics
        # (MetricList = repeated field-1 Metric): identity serializer
        self._send_v1 = self._channel.unary_unary(
            "/forwardrpc.Forward/SendMetrics",
            request_serializer=_raw, response_deserializer=_raw)
        self._v1_ok = True
        self.stats: Dict[str, int] = {
            "forwarded_total": 0, "errors_deadline": 0,
            "errors_unavailable": 0, "errors_send": 0,
            "remote_received": 0, "remote_merged": 0,
            "remote_duplicates": 0}
        self.last_flow: Optional[dict] = None

    @property
    def errors(self) -> int:
        return (self.stats["errors_deadline"]
                + self.stats["errors_unavailable"]
                + self.stats["errors_send"])

    def forward(self, fwd: ForwardableState) -> int:
        """Send one flush's state; returns the metrics sent (0 on a
        failure, which is counted and logged). Uses `fwd.wire` when the
        caller encoded it already."""
        if not len(fwd):
            return 0
        protos = fwd.wire if fwd.wire is not None else forwardable_to_wire(
            fwd)
        if not protos:
            return 0
        self._token_seq += 1
        token = f"fwd:{self._token_id}:{self._token_seq}"
        try:
            self._v1_ok, resp = send_batch(
                self._send_v1, self._send_v2, protos, self.deadline,
                self._v1_ok, pin_codes=_PIN_CODES,
                metadata=token_metadata(token))
        except grpc.RpcError as e:
            code = e.code()
            if code == grpc.StatusCode.DEADLINE_EXCEEDED:
                self.stats["errors_deadline"] += 1
            elif code == grpc.StatusCode.UNAVAILABLE:
                self.stats["errors_unavailable"] += 1
            else:
                self.stats["errors_send"] += 1
            logger.warning("could not forward %d metrics to %s: %s %s",
                           len(protos), self.address, code, e.details())
            return 0
        self.stats["forwarded_total"] += len(protos)
        flow = self.last_flow = decode_flow_counts(resp)
        if flow is not None:
            self.stats["remote_received"] += flow["received"]
            self.stats["remote_merged"] += flow["merged"]
            self.stats["remote_duplicates"] += int(flow["duplicate"])
        logger.debug("forwarded %d metrics to %s", len(protos), self.address)
        return len(protos)

    def close(self) -> None:
        self._channel.close()
