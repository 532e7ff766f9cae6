"""FNV-1a hashing, used for metric-key digests and worker sharding.

Behavioral parity: the reference keys workers by a 32-bit fnv1a digest of
name, type and joined tags (reference samplers/parser.go:44-61 via
segmentio/fasthash). We additionally provide a 64-bit variant used as the
host dictionary key for the device column store (lower collision rate) and
for HLL member hashing.
"""

_FNV32_OFFSET = 0x811C9DC5
_FNV32_PRIME = 0x01000193
_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def fnv1a_32(data: bytes, h: int = _FNV32_OFFSET) -> int:
    for b in data:
        h = ((h ^ b) * _FNV32_PRIME) & _M32
    return h


def fnv1a_64(data: bytes, h: int = _FNV64_OFFSET) -> int:
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & _M64
    return h


def init32() -> int:
    return _FNV32_OFFSET


def init64() -> int:
    return _FNV64_OFFSET
