"""The port's reshard range-segment wire (forward/rangewire.py) against
the JAX package's (veneur_tpu/forward/rangewire.py), on the CPU: every
frame encoder byte for byte on the same seeded rows in every scope, the
l-stat sidecar byte for byte, and the decode of one segment (the port's
frames through both decoders, and a round trip through the port's) with
the scope kept as it was written, the sidecar read back exactly, and a
corrupt frame counted, not fatal."""

from __future__ import annotations

import zlib

import numpy as np
import pytest

from veneur_tpu.core.columnstore import RowMeta as JRowMeta
from veneur_tpu.forward import rangewire as jrw
from veneur_tpu.samplers.metrics import MetricScope as JScope
from veneur_tpu_torch.core.columnstore import RowMeta as TRowMeta
from veneur_tpu_torch.forward import rangewire as trw
from veneur_tpu_torch.ops import hll_ref, llhist_ref
from veneur_tpu_torch.samplers.metrics import MetricScope as TScope

SCOPES = (0, 1, 2)  # mixed, local-only, global-only


def _metas(family: str, scope: int, n: int = 6):
    """The same row identities as the port's and the JAX package's
    RowMeta."""
    wire = {"counter": "counter", "gauge": "gauge", "timer": "timer",
            "histogram": "histogram", "llhist": "llhist",
            "set": "set"}[family]
    out = []
    for i in range(n):
        tags = [f"env:e{i % 3}", f"shard:{i}"] if i % 2 else []
        joined = ",".join(tags)
        out.append((
            TRowMeta(name=f"rw.{family}.{i}", tags=list(tags),
                     joined_tags=joined, digest32=i, scope=TScope(scope),
                     wire_type=wire),
            JRowMeta(name=f"rw.{family}.{i}", tags=list(tags),
                     joined_tags=joined, digest32=i, scope=JScope(scope),
                     wire_type=wire)))
    return out


def _histo_rows(rng, n):
    rows = []
    for i in range(n):
        k = 3 + i * 7
        weights = rng.integers(0, 4, k).astype(np.float32)
        weights[0] = 1.0  # at least one centroid
        means = np.sort(rng.normal(50, 20, k)).astype(np.float32)
        rows.append((means, weights, np.float32(means.min()),
                     np.float32(means.max()),
                     np.float32(rng.random() * 3)))
    return rows


@pytest.mark.parametrize("scope", SCOPES)
@pytest.mark.parametrize("family", ["counter", "gauge", "timer",
                                    "histogram", "llhist", "set"])
def test_frames_equal_jax_bytes(family, scope):
    rng = np.random.default_rng(zlib.crc32(f"{family}:{scope}".encode()))
    metas = _metas(family, scope)
    if family == "counter":
        # integral totals, a zero total, a negative and a large one
        vals = [0.0, 3.0, -7.0, 2.0**40, 12345.0, 1.0]
        pairs = [(trw.counter_to_wire(t, v), jrw.counter_to_wire(j, v))
                 for (t, j), v in zip(metas, vals)]
    elif family == "gauge":
        vals = rng.normal(0, 1e3, len(metas)).astype(np.float32)
        pairs = [(trw.gauge_to_wire(t, v), jrw.gauge_to_wire(j, v))
                 for (t, j), v in zip(metas, vals)]
    elif family in ("timer", "histogram"):
        pairs = [(trw.histogram_to_wire(t, *h), jrw.histogram_to_wire(j, *h))
                 for (t, j), h in zip(metas, _histo_rows(rng, len(metas)))]
    elif family == "llhist":
        pairs = []
        for t, j in metas:
            bins = np.zeros(llhist_ref.BINS, np.int64)
            hit = rng.integers(0, llhist_ref.BINS, 9)
            bins[hit] = rng.integers(1, 1000, 9)
            pairs.append((trw.llhist_to_wire(t, bins),
                          jrw.llhist_to_wire(j, bins)))
    else:
        pairs = []
        for t, j in metas:
            regs = np.zeros(hll_ref.M, np.int8)
            # sparse and dense register rows both
            k = 20 if rng.random() < 0.5 else 9000
            regs[rng.integers(0, hll_ref.M, k)] = rng.integers(1, 30, k)
            pairs.append((trw.set_to_wire(t, regs), jrw.set_to_wire(j, regs)))
    for got, want in pairs:
        assert got == want


def test_lstat_sidecar_equals_jax_bytes():
    rng = np.random.default_rng(5)
    stats = {k: [float(np.float32(x)) for x in rng.normal(0, 100, 7)]
             for k in trw.LSTAT_FIELDS}
    stats["lmin"][0] = float("inf")
    stats["lmax"][0] = float("-inf")
    assert trw.lstat_sidecar(stats) == jrw.lstat_sidecar(stats)
    assert trw.LSTAT_MAGIC == jrw.LSTAT_MAGIC == b"VRS1"
    assert trw.LSTAT_FIELDS == jrw.LSTAT_FIELDS


def _segment(scope: int, rng):
    """One range segment of every family at `scope`, with a sidecar
    aligned to its histogram frames; returns (frames, expected)."""
    frames, want = [], {}
    c = _metas("counter", scope, 3)
    g = _metas("gauge", scope, 3)
    h = _metas("timer", scope, 3)
    ll = _metas("llhist", scope, 2)
    s = _metas("set", scope, 2)
    want["counter"] = [5.0, 0.0, -2.0]
    frames += [trw.counter_to_wire(t, v) for (t, _), v in
               zip(c, want["counter"])]
    want["gauge"] = [float(np.float32(x)) for x in rng.normal(0, 10, 3)]
    frames += [trw.gauge_to_wire(t, v) for (t, _), v in zip(g, want["gauge"])]
    hist = _histo_rows(rng, 3)
    frames += [trw.histogram_to_wire(t, *row) for (t, _), row in
               zip(h, hist)]
    want["histogram"] = hist
    bins = []
    for t, _ in ll:
        b = np.zeros(llhist_ref.BINS, np.int64)
        b[rng.integers(0, llhist_ref.BINS, 5)] = rng.integers(1, 50, 5)
        bins.append(b)
        frames.append(trw.llhist_to_wire(t, b))
    want["llhist"] = bins
    regs = []
    for t, _ in s:
        r = np.zeros(hll_ref.M, np.int8)
        r[rng.integers(0, hll_ref.M, 40)] = rng.integers(1, 20, 40)
        regs.append(r)
        frames.append(trw.set_to_wire(t, r))
    want["set"] = regs
    lstats = {k: [float(np.float32(x)) for x in rng.normal(0, 9, 3)]
              for k in trw.LSTAT_FIELDS}
    frames.append(trw.lstat_sidecar(lstats))
    want["lstats"] = lstats
    want["names"] = [t.name for t, _ in c + g + h + ll + s]
    return frames, want


def _decoded_view(batch):
    """A comparable view of a DecodedBatch of either package."""
    def stubs(xs):
        return [(x.key.name, x.key.type, x.key.joined_tags, x.digest,
                 x.digest64, tuple(x.tags), int(x.scope)) for x in xs]
    return {
        "counter": (stubs(batch.counter_stubs), batch.counter_values),
        "gauge": (stubs(batch.gauge_stubs), batch.gauge_values),
        "histogram": (stubs(batch.histo_stubs),
                      [m.tolist() for m in batch.histo_means],
                      [w.tolist() for w in batch.histo_weights],
                      batch.histo_mins, batch.histo_maxs,
                      batch.histo_recips),
        "llhist": (stubs(batch.llhist_stubs),
                   [b.tolist() for b in batch.llhist_bins]),
        "set": (stubs(batch.set_stubs),
                [np.asarray(r).tolist() for r in batch.set_regs]),
        "lstats": batch.lstats,
        "metrics": batch.metrics,
        "parse_errors": batch.parse_errors,
    }


@pytest.mark.parametrize("scope", SCOPES)
def test_decode_equals_jax_and_keeps_scope(scope):
    rng = np.random.default_rng(scope + 11)
    frames, want = _segment(scope, rng)
    got = trw.decode_segment(frames)
    jgot = jrw.decode_segment(frames)
    assert _decoded_view(got) == _decoded_view(jgot)
    # the scope comes back as written, for counters and gauges too (the
    # forward path's import would coerce them to global-only)
    for stub in (got.counter_stubs + got.gauge_stubs + got.histo_stubs
                 + got.llhist_stubs + got.set_stubs):
        assert int(stub.scope) == scope
    assert got.metrics == 13 and got.parse_errors == 0
    assert got.counter_values == want["counter"]
    assert got.gauge_values == want["gauge"]
    assert got.lstats == want["lstats"]
    assert [s.key.name for s in got.counter_stubs + got.gauge_stubs
            + got.histo_stubs + got.llhist_stubs
            + got.set_stubs] == want["names"]
    for (means, weights, dmin, dmax, drecip), m, w, lo, hi, rc in zip(
            want["histogram"], got.histo_means, got.histo_weights,
            got.histo_mins, got.histo_maxs, got.histo_recips):
        nz = weights > 0
        np.testing.assert_array_equal(m, means[nz].astype(np.float64))
        np.testing.assert_array_equal(w, weights[nz].astype(np.float64))
        assert (lo, hi, rc) == (float(dmin), float(dmax), float(drecip))
    for b, gb in zip(want["llhist"], got.llhist_bins):
        np.testing.assert_array_equal(np.asarray(gb)[:llhist_ref.BINS], b)
    for r, gr in zip(want["set"], got.set_regs):
        np.testing.assert_array_equal(np.asarray(gr, np.int8), r)


def test_decode_counts_corrupt_frames_like_jax():
    rng = np.random.default_rng(3)
    frames, _ = _segment(0, rng)
    frames = frames[:3] + [b"\x0a\xff\xff", b"VRS1{not json"] + frames[3:-1]
    got = trw.decode_segment(frames)
    jgot = jrw.decode_segment(frames)
    assert _decoded_view(got) == _decoded_view(jgot)
    assert got.parse_errors == 2
    assert got.metrics == 13
    assert got.lstats is None
