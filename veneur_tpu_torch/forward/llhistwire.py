"""llhist forward-plane payload codec.

The LLHistValue proto carries the dense register row as opaque bytes in
one of two self-describing encodings:

  0x01 sparse: varint bin-count, then per occupied bin a (varint
       index-delta-from-previous, varint count) pair in ascending bin
       order. A typical latency key occupies a few dozen of the 4501
       bins, so this is ~100x smaller than the dense row.
  0x02 dense: every register as a varint in bin order (used past a
       quarter occupancy, where delta pairs stop paying for themselves).

Counts are unsigned varints (carryover-merged rows can exceed int32).
A copy of veneur_tpu/forward/llhistwire.py; like hllwire, numpy and the
standard library only.
"""

from __future__ import annotations

import numpy as np

from veneur_tpu_torch.ops import llhist_ref

SPARSE = 0x01
DENSE = 0x02


class LLHistWireError(ValueError):
    pass


def _put_varint(out: bytearray, n: int) -> None:
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _get_varint(data: bytes, pos: int):
    shift = 0
    val = 0
    while True:
        if pos >= len(data):
            raise LLHistWireError("truncated varint")
        b = data[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 70:
            raise LLHistWireError("varint overflow")


def marshal(bins) -> bytes:
    """Dense register row (any int dtype, length BINS or longer — extra
    device padding is ignored) -> wire bytes. Defensive floor at 0: a
    register that wrapped the device table's int32 (>2^31 weighted
    samples into ONE bin in one interval) must degrade to a missing
    count, not crash the whole interval's forward send."""
    arr = np.asarray(bins, np.int64)[: llhist_ref.BINS]
    arr = np.maximum(arr, 0)
    nz = np.flatnonzero(arr)
    out = bytearray()
    if nz.size * 2 >= llhist_ref.BINS // 2:
        out.append(DENSE)
        for v in arr.tolist():
            _put_varint(out, int(v))
        return bytes(out)
    out.append(SPARSE)
    _put_varint(out, int(nz.size))
    prev = 0
    counts = arr[nz].tolist()
    for idx, cnt in zip(nz.tolist(), counts):
        _put_varint(out, idx - prev)
        _put_varint(out, int(cnt))
        prev = idx
    return bytes(out)


def unmarshal(data: bytes) -> np.ndarray:
    """Wire bytes -> (BINS,) int64 register row."""
    if not data:
        raise LLHistWireError("empty llhist payload")
    out = np.zeros(llhist_ref.BINS, np.int64)
    kind = data[0]
    pos = 1
    if kind == DENSE:
        for i in range(llhist_ref.BINS):
            v, pos = _get_varint(data, pos)
            out[i] = v
        return out
    if kind != SPARSE:
        raise LLHistWireError(f"unknown llhist encoding 0x{kind:02x}")
    n, pos = _get_varint(data, pos)
    if n > llhist_ref.BINS:
        raise LLHistWireError(f"implausible bin count {n}")
    idx = 0
    for _ in range(n):
        delta, pos = _get_varint(data, pos)
        cnt, pos = _get_varint(data, pos)
        idx += delta
        if idx >= llhist_ref.BINS:
            raise LLHistWireError(f"bin index {idx} out of range")
        out[idx] = cnt
    return out
