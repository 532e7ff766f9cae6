"""axiomhq/hyperloglog binary wire format (version 1); a copy of
veneur_tpu/forward/hllwire.py.

The reference serializes set state on the forward plane with the axiomhq
sketch's MarshalBinary and merges imports via UnmarshalBinary (reference
samplers/samplers.go:279-311, vendor/github.com/axiomhq/hyperloglog/
hyperloglog.go:274-380). This module speaks that format so sets exchanged
with a Go veneur merge instead of being dropped:

  header:  [version=1, p, b, sparse?]
  dense:   4-byte BE tailcut count, then count bytes; each byte packs two
           4-bit registers (high nibble = even index) stored relative to
           the base b (hyperloglog.go:167-182 insert, registers.go).
  sparse:  tmpSet  = 4-byte BE count + count 4-byte BE encoded hashes,
           then a compressed list = BE count, BE last, BE byte-size and
           varint-encoded deltas of sorted encoded hashes (compressed.go,
           sparse.go encodeHash/decodeHash with pp=25).

Our own device tables hold plain per-register rho bytes, so marshalling
always emits the dense form (valid input to any axiomhq Merge) and
unmarshalling expands either form back to a flat register array.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

VERSION = 1
PP = 25  # sparse precision (hyperloglog.go: pp)
CAPACITY = 16  # 4-bit tailcut registers


class HLLWireError(ValueError):
    pass


def _clz64(x: int) -> int:
    return 64 - x.bit_length() if x else 64


def _bextr32(v: int, start: int, length: int) -> int:
    return (v >> start) & ((1 << length) - 1)


def encode_hash(x: int, p: int = 14) -> int:
    """Sparse-representation encoding of a 64-bit member hash
    (sparse.go encodeHash)."""
    idx = (x >> (64 - PP)) & ((1 << PP) - 1)
    if (x >> (64 - PP)) & ((1 << (PP - p)) - 1) == 0:
        w = (((x & ((1 << (64 - PP)) - 1)) << PP)
             | (1 << (PP - 1))) & 0xFFFFFFFFFFFFFFFF
        zeros = _clz64(w) + 1
        return (idx << 7) | (zeros << 1) | 1
    return idx << 1


def decode_hash(k: int, p: int = 14) -> Tuple[int, int]:
    """Sparse key -> (register index, rho) (sparse.go decodeHash)."""
    if k & 1:
        r = _bextr32(k, 1, 6) + PP - p
        idx = _bextr32(k, 32 - p, p)
    else:
        # the Go shift happens in uint32 before widening, so it truncates
        w = (k << (32 - PP + p - 1)) & 0xFFFFFFFF
        r = _clz64(w) - 31
        idx = _bextr32(k, PP - p + 1, p)
    return idx, r


def marshal_dense(regs: np.ndarray, p: int = 14) -> bytes:
    """Flat rho registers -> dense axiomhq sketch bytes.

    Values above the 4-bit tailcut range clamp exactly as the Go insert
    path would have (val = min(r-b, 15), hyperloglog.go:176-181); the
    base b only rises when every register is occupied, so it is derived
    from the register minimum the same way rebase would."""
    regs = np.asarray(regs).astype(np.int32) & 0xFF
    m = regs.shape[0]
    if m != (1 << p):
        raise HLLWireError(f"register count {m} != 2^{p}")
    b = 0
    minv = int(regs.min()) if m else 0
    maxv = int(regs.max()) if m else 0
    if maxv >= CAPACITY and minv > 0:
        b = min(minv, maxv - (CAPACITY - 1))
    vals = np.clip(regs - b, 0, CAPACITY - 1).astype(np.uint8)
    tailcuts = ((vals[0::2] << 4) | vals[1::2]).astype(np.uint8)
    out = bytearray((VERSION, p, b, 0))
    out += len(tailcuts).to_bytes(4, "big")
    out += tailcuts.tobytes()
    return bytes(out)


def marshal_sparse(regs: np.ndarray, p: int = 14) -> bytes:
    """Flat rho registers -> sparse axiomhq sketch bytes.

    Each occupied register (idx, rho) maps to the unique sparse key
    whose decodeHash returns exactly that pair (sparse.go
    encodeHash/decodeHash inverted): rho <= pp-p packs the rank into
    the hash-remainder bits (LSB=0), larger rho uses the explicit
    zero-count form (LSB=1). Keys go out as the sorted delta-varint
    compressed list with an empty tmpSet (compressed.go,
    hyperloglog.go:282-298), so any Go UnmarshalBinary+Merge accepts
    the payload; a 10-member set costs ~60 bytes instead of the ~8 KB
    dense form."""
    regs = np.asarray(regs).astype(np.int64) & 0xFF
    m = regs.shape[0]
    if m != (1 << p):
        raise HLLWireError(f"register count {m} != 2^{p}")
    idx = np.nonzero(regs)[0]
    rho = regs[idx]
    split = PP - p
    low = rho <= split
    keys = np.where(
        low,
        ((idx << split) | (1 << np.maximum(split - rho, 0))) << 1,
        (idx << (32 - p)) | (np.maximum(rho - split, 0) << 1) | 1,
    ).astype(np.uint64)
    keys = np.sort(keys)
    deltas = np.diff(keys, prepend=np.uint64(0))
    buf = bytearray()
    for d in deltas.tolist():
        while d & ~0x7F:
            buf.append((d & 0x7F) | 0x80)
            d >>= 7
        buf.append(d)
    out = bytearray((VERSION, p, 0, 1))
    out += (0).to_bytes(4, "big")                  # empty tmpSet
    out += len(keys).to_bytes(4, "big")            # list count
    out += (int(keys[-1]) if len(keys) else 0).to_bytes(4, "big")  # last
    out += len(buf).to_bytes(4, "big")             # byte size
    out += buf
    return bytes(out)


def marshal(regs: np.ndarray, p: int = 14) -> bytes:
    """Registers -> the smaller of the sparse and dense encodings.

    The reference's vendored sketch emits sparse until the sketch
    converts (hyperloglog.go:274-298); both forms are valid Merge input,
    so the choice is purely a wire-size one. Delta varints run 2-5 bytes
    per occupied register (spacing-dependent), so near the dense size
    (m/2 + 8) the sparse form is built and measured; clearly-dense
    occupancies skip the attempt."""
    regs_arr = np.asarray(regs)
    vals = regs_arr.astype(np.int32) & 0xFF  # int8 inputs mask like Go
    m = regs_arr.shape[0]
    dense_size = m // 2 + 8
    nnz = int(np.count_nonzero(vals))
    if nnz * 2 + 20 > dense_size:  # >= 2 bytes/key: sparse can't win
        return marshal_dense(regs_arr, p)
    if nnz and int(vals.max()) > (PP - p) + 63:
        # the sparse LSB=1 rank field is 6 bits; a rho beyond pp-p+63
        # (possible after merging a based dense import) would overflow
        # into the index bits and decode wrong — dense handles it via
        # the base offset instead
        return marshal_dense(regs_arr, p)
    sparse = marshal_sparse(regs_arr, p)
    if len(sparse) <= dense_size:
        return sparse
    return marshal_dense(regs_arr, p)


def unmarshal(data: bytes) -> Tuple[np.ndarray, int]:
    """Sketch bytes (dense or sparse) -> (flat registers, precision)."""
    if len(data) < 8:
        raise HLLWireError(f"short HLL payload ({len(data)} bytes)")
    p = data[1]
    if not 4 <= p <= 18:
        raise HLLWireError(f"precision {p} out of range")
    b = data[2]
    m = 1 << p
    regs = np.zeros(m, np.uint8)

    if data[3] == 1:  # sparse
        tssz = int.from_bytes(data[4:8], "big")
        off = 8
        end = off + 4 * tssz
        if end > len(data):
            raise HLLWireError("sparse tmpSet truncated")
        keys = [int.from_bytes(data[i:i + 4], "big")
                for i in range(off, end, 4)]
        off = end
        if off + 12 > len(data):
            raise HLLWireError("sparse list header truncated")
        # compressed list: count and last are redundant with the payload
        off += 8
        sz = int.from_bytes(data[off:off + 4], "big")
        off += 4
        if off + sz > len(data):
            raise HLLWireError("sparse list truncated")
        buf = data[off:off + sz]
        i = 0
        last = 0
        n = len(buf)
        while i < n:
            x = 0
            shift = 0
            while buf[i] & 0x80:
                x |= (buf[i] & 0x7F) << shift
                shift += 7
                i += 1
                if i >= n:  # continuation bit on the final byte
                    raise HLLWireError("truncated varint in sparse list")
            x |= buf[i] << shift
            i += 1
            last += x
            keys.append(last)
        for k in keys:
            idx, r = decode_hash(k, p)
            if r > regs[idx]:
                regs[idx] = r
        return regs, p

    sz = int.from_bytes(data[4:8], "big")
    if sz != m // 2 or 8 + sz > len(data):
        raise HLLWireError(f"dense payload size mismatch ({sz} tailcuts)")
    tc = np.frombuffer(data[8:8 + sz], np.uint8)
    regs[0::2] = tc >> 4
    regs[1::2] = tc & 0x0F
    if b:
        # registers are stored relative to the base; Go's estimator adds
        # the base back for every register (registers.go sumAndZeros)
        regs = (regs + b).astype(np.uint8)
    return regs, p
