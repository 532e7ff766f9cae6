"""Forward plane: the local->global distribution tier over gRPC (torch
port of veneur_tpu/forward/).

Wire- and route-compatible with the reference (forwardrpc/forward.proto,
samplers/metricpb/metric.proto): local servers stream mergeable state
(t-digests, HLL registers, global counters and gauges) to a global
server through /forwardrpc.Forward/SendMetricsV2; the global side merges
into its column store (counter add, gauge overwrite, HLL register max,
digest recompress).

The package __init__ is lazy (PEP 562): convert, client and server pull
torch at import, and consumers that need none of it (the proxy tier
imports only forward.protos and forward.wire) must not pay for it just
for touching a subpackage.
"""

_EXPORTS = {
    "forwardable_to_protos": "veneur_tpu_torch.forward.convert",
    "metric_key_of_proto": "veneur_tpu_torch.forward.convert",
    "ForwardClient": "veneur_tpu_torch.forward.client",
    "ImportServer": "veneur_tpu_torch.forward.server",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module 'veneur_tpu_torch.forward' has no "
                             f"attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)
