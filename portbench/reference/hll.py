"""HyperLogLog at precision 14 with the LogLog-Beta estimator, as the
port's sets state it: the member hash is fnv1a-64 followed by the
murmur3 finalizer; the estimate adds one and truncates (the reference
veneur's vendored hyperloglog.go:225-231). A frozen copy of the
arithmetic, vectorised over members and keys."""

from __future__ import annotations

import math
from typing import List

import numpy as np

P = 14
M = 1 << P
ALPHA = 0.7213 / (1 + 1.079 / M)
BETA14 = (0.070471823, 0.17393686, 0.16339839, -0.09237745,
          0.03738027, -0.005384159, 0.00042419)
BETA14_EZ = -0.370393911
FNV64_OFFSET = 0xCBF29CE484222325
FNV64_PRIME = 0x100000001B3


def member_hashes(members: List[bytes]) -> np.ndarray:
    """fnv1a-64 then the murmur3 finalizer of each member (uint64)."""
    out = np.empty(len(members), np.uint64)
    lengths = np.fromiter((len(m) for m in members), np.int64, len(members))
    prime = np.uint64(FNV64_PRIME)
    with np.errstate(over="ignore"):
        for n in np.unique(lengths).tolist():
            at = np.flatnonzero(lengths == n)
            raw = np.frombuffer(b"".join(members[i] for i in at.tolist()),
                                np.uint8).reshape(at.size, n).astype(
                                    np.uint64)
            h = np.full(at.size, FNV64_OFFSET, np.uint64)
            for col in range(n):
                h = (h ^ raw[:, col]) * prime
            out[at] = h
        for mult in (0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53):
            out ^= out >> np.uint64(33)
            out *= np.uint64(mult)
        out ^= out >> np.uint64(33)
    return out


def registers_of(members: List[bytes]) -> tuple:
    """(register index int64, rho int8) of each member."""
    h = member_hashes(members)
    idx = (h >> np.uint64(64 - P)).astype(np.int64)
    w = (h << np.uint64(P)) | np.uint64(1 << (P - 1))
    lz = np.zeros(w.size, np.int64)
    for shift in (32, 16, 8, 4, 2, 1):
        top = (w >> np.uint64(64 - shift)) == 0
        lz[top] += shift
        w[top] <<= np.uint64(shift)
    return idx, (lz + 1).astype(np.int8)


def _beta14(ez: float) -> float:
    zl = math.log(ez + 1.0)
    acc = BETA14_EZ * ez
    zp = 1.0
    for c in BETA14:
        zp *= zl
        acc += c * zp
    return acc


def estimates(nonzero: np.ndarray, inv_sum: np.ndarray) -> np.ndarray:
    """Estimates of dense registers described by their count of nonzero
    registers and the sum of 2**-rho over those (exact in float64 for
    the ranks a set of this size reaches). An empty set estimates 0."""
    nonzero = np.asarray(nonzero, np.int64)
    ez = (M - nonzero).astype(np.float64)
    s = ez + np.asarray(inv_sum, np.float64)
    distinct, inverse = np.unique(ez, return_inverse=True)
    beta = np.array([_beta14(float(z)) for z in distinct],
                    np.float64)[inverse]
    est = np.floor(ALPHA * M * (M - ez) / (beta + s) + 1.0)
    return np.where(nonzero > 0, est, 0.0)

