"""mTLS for the gRPC forward plane (proxy, import server, clients); a
copy of veneur_tpu/util/grpctls.py.

Parity with reference proxy/proxy.go:33-120 (the proxy terminates TLS on
its gRPC server and dials destinations with client credentials) and
util/tls.go (cert bundle loading). Every field accepts either an
inline PEM string (matching the reference's YAML) or a file path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


def _pem_bytes(value) -> Optional[bytes]:
    """Inline PEM or file path -> PEM bytes (None when unset)."""
    if value is None:
        return None
    if hasattr(value, "reveal"):  # StringSecret
        value = value.reveal()
    if not value:
        return None
    if "-----BEGIN" in value:
        return value.encode()
    with open(value, "rb") as f:
        return f.read()


@dataclass
class GrpcTLS:
    """One side's credential bundle.

    certificate/key: this side's cert chain and private key.
    authority: CA bundle used to verify the peer; on the server side its
    presence additionally REQUIRES client certificates (mutual auth),
    mirroring tls_authority_certificate on the TCP plane.
    """

    certificate: str = ""
    key: str = ""
    authority: str = ""

    def __bool__(self) -> bool:
        return bool(self.certificate or self.key or self.authority)

    def server_credentials(self):
        import grpc

        cert, key, ca = (_pem_bytes(self.certificate), _pem_bytes(self.key),
                         _pem_bytes(self.authority))
        if not (cert and key):
            # half-configured TLS must fail loudly, never fall back to
            # plaintext
            raise ValueError(
                "gRPC TLS needs both certificate and key on the server side")
        return grpc.ssl_server_credentials(
            [(key, cert)], root_certificates=ca,
            require_client_auth=ca is not None)

    def channel_credentials(self):
        import grpc

        cert, key, ca = (_pem_bytes(self.certificate), _pem_bytes(self.key),
                         _pem_bytes(self.authority))
        if (cert is None) != (key is None):
            raise ValueError(
                "gRPC client TLS needs certificate and key together")
        return grpc.ssl_channel_credentials(
            root_certificates=ca, private_key=key, certificate_chain=cert)


# Reconnect backoff cap shared by every forward-plane dialer (local
# client AND proxy destinations). Load-bearing for the HA design: grpc's
# default backoff climbs past 20s after an outage, which would keep a
# freshly-restored global looking dead for whole flush intervals /
# probe rounds — recovery must land at probe speed, and both tiers must
# agree on it.
RECONNECT_BACKOFF_OPTIONS = (
    ("grpc.initial_reconnect_backoff_ms", 250),
    ("grpc.min_reconnect_backoff_ms", 250),
    ("grpc.max_reconnect_backoff_ms", 2000),
)


def secure_or_insecure_channel(address: str, tls: Optional[GrpcTLS],
                               **kwargs):
    """Dial helper shared by the forward client and proxy destinations."""
    import grpc

    if tls:
        return grpc.secure_channel(address, tls.channel_credentials(),
                                   **kwargs)
    return grpc.insecure_channel(address, **kwargs)
