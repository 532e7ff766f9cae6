#!/usr/bin/env python3
"""Chip smoke test of veneur_tpu_torch: builds the CUDA kernels and the
native parser, holds each kernel against its plain PyTorch version on the
card, then runs the port's server end to end on the card.

    python3 chip_smoke.py

Needs one CUDA card and g++ (it exits non-zero without either, and when
the package is not beside it). Phases, each fatal on failure:

  1. the card's name and power limit (nvidia-smi), g++, torch, CUDA,
     grpc and protobuf versions;
  2. build every kernel from veneur_tpu_torch/csrc with nvcc and the
     native parser from veneur_tpu_torch/native with g++;
  3. each kernel against its plain version on the card at the main path's
     shapes, with its median time (CUDA events), the plain version's
     time, a one-call PyTorch yardstick where one exists, and the least
     time the card could take (its bound): K1 t-digest flush, K2 HLL
     estimate, K3 llhist scatter-add (a uniform 8192-sample buffer,
     hot keys, a 65 536-sample pump chunk at phase B's shape, and
     sender-ordered samples; each also against index_add_'s eager call),
     the host cost of the pieces of K3's launch path, then K3's table
     route (one 65 536-sample chunk through LLHistTable: one packed
     block, one copy, one launch; against the per-batch route, eight
     pieces of 8192 each with three pageable copies and a launch, and
     beside the packed block's copy from pinned memory) and a stress of
     256 back-to-back chunks;
  4. phase A: a Server on cuda:0 on the native pump ingests ~0.88 M
     DogStatsD lines over loopback UDP (40k counter, 20k gauge, 30k timer
     x 16 and 10k set x 32 keys) in each of two intervals, flushes after
     each, and every series is checked: counters, gauges and timer
     min/max/count exactly, timer p50/p99 against the rank slack of the
     t-digest's k-scale, set estimates against the reference HLL;
  5. phase B: a `histogram_encoding: circllhist` Server with two native
     readers and 65 536 llhist rows takes 30k timer keys x 16, 5k `|l`
     keys x 32 (rates 1 and 0.5, some values outside the bin window) and
     20k counter keys from eight sender sockets, two intervals; every
     `.count`, `.bucket` line and counter exactly, `.sum` against the
     bins' midpoint sum, and every percentile against llhist_ref and
     within one bin of the sample quantile of what was sent;
  6. phase C: the numpy columnar decoder (`tpu.disable_native_parser`)
     on a tenth of phase A's corpus plus 500 `|l` keys, with the checks
     of phases A and B;
  7. phase D, the forward tier: two local Servers on the native pump
     forward to one global Server over gRPC (127.0.0.1), all on cuda:0.
     Each local takes phase A's key set and 5 000 `|l` keys x 32 in each
     of two intervals, half of the counter and gauge keys global-only
     (each global-only gauge sent by one local), set members overlapping
     by half. Per interval both locals flush (the export flush, K1; the
     forward send) and the global, which merged their state, flushes.
     Checked: the locals' mixed counters and gauges and timer min/max/
     count exactly, and no forwarded series among them; the global's
     counters (the sum), gauges, every llhist `.count` and `.bucket`
     line exactly, timer p50/p99 within the rank slack of both locals'
     samples, set estimates equal to the reference HLL over the union;
     the forward accounting (forwarded, imported, FlowCounts) and that
     no row took the proto fallback encoder;
  8. phase E, forward resilience: one local (phase D's per-local corpus,
     `carryover_max_intervals: 3`, `forward_retry_max_attempts: 3`,
     `circuit_breaker_failure_threshold: 3`) and one global at a fixed
     127.0.0.1 port, all on cuda:0. E1: interval 1 as in phase D; in
     interval 2 the global's import server is down, the send fails after
     its retries and the carryover holds the interval's 75 000 rows; in
     interval 3 the import server is back at the same address and one
     send carries intervals 2 and 3 merged, and the global's flush is
     checked against the union (counters summed, interval 3's gauges,
     samples and set members of both). E2: a local with `forward_wal:
     true` appends (fsync'd) an interval while the global is down and
     is shut down; a fresh local on the same spool replays the segment
     to the restarted global (`wal_stale_after_intervals: 0.001` on
     both, 3.6 s), which files it in its backfill plane; two global
     flushes emit every series of it `backfilled`, at the interval's
     original start, checked as above; the segment, put back after its
     replay, replays again and is dropped as a duplicate.
  9. phase F, the sink plane: phase A's corpus plus 5 000 `|l` keys x
     32 into the channel, datadog, cortex and prometheus sinks (the
     datadog and cortex ones at capturing fakes on 127.0.0.1), two
     intervals; each fake's series equal to the sink's own rendering;
 10. phase F2, the thread plane: `interval: 5s`, four intervals on the
     server's flush loop, a blocking and a failing sink beside datadog:
     the deadline join, the skips, the breaker and the spill;
 11. phase G, the operator surface: phase F's corpus plus 500 host-tier
     set keys into a server with the HTTP API, `stats_address` at its
     own UDP listener, the diagnostics loop, the flush watchdog and 64
     alert rules at 1 s (8 of them crossed by the corpus). Readiness
     turns 503 when the last flush is set back past the watchdog's
     budget. Eight HTTP readers query `/query` from interval 2's ingest
     through its flush, and every query they send must be answered 200;
     one diagnostics round runs after the ingest; then, ingest stopped,
     336 rows of every family are queried (t-digest p50/p99 through K1,
     promoted sets through K2, host-tier sets, llhist, counters, gauges)
     and must equal the flush that follows bit for bit; the 8 rules fire
     and 56 stay idle; `/metrics` parses and carries the route,
     torch.cuda device-memory, query and alert rows; the first flush's
     self-metrics and the diagnostics gauges (`mem.rss_bytes`, the
     torch.cuda `device.bytes_in_use`) come out of the second; each
     kernel launch is booked to the flush, the queries, the alert loop
     or ingest.

Before any value is checked, each phase asserts that the server received
every line it was sent and that no ingest chunk failed to apply (phase D
also that no forward send or import merge failed, phase E that only the
outage's sends failed). It
prints a `details` JSON line (every measurement, and the register and
shared-memory use ptxas reported for each kernel), a `kernels` JSON line
(with each kernel's launches counted in the server phases alone), and
last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# device memory rate by card name (NVIDIA data sheets), bytes/s; float32
# rate outside the tensor cores, operations/s (H100 SXM: 67 TFLOP/s),
# also taken as the rate of int32 adds on the same cores
_MEM_RATE = {"H100 80GB HBM3": 3.35e12, "H100 PCIe": 2.0e12,
             "H100 NVL": 3.9e12, "H200": 4.8e12}
_F32_RATE = {"H100 80GB HBM3": 67e12, "H100 PCIe": 51e12,
             "H100 NVL": 60e12, "H200": 67e12}

PS = (0.5, 0.9, 0.99)
K1_TOL = dict(rtol=2e-5, atol=1e-4)  # tests/test_pallas.py:97
K2_RTOL = 1e-5                       # tests/test_pallas.py:24
LL_RTOL = 1e-5  # device float32 ranks against llhist_ref's float64 ones
PAD_ROW = 2**31 - 1


def _rate(table: dict, card: str) -> float:
    for key, rate in table.items():
        if key in card:
            return rate
    raise RuntimeError(f"no published rate for card {card!r}")


def _bound(card: str, nbytes: int, nops: int) -> dict:
    bytes_ms = nbytes / _rate(_MEM_RATE, card) * 1e3
    ops_ms = nops / _rate(_F32_RATE, card) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": nops}


def _timed_ms(run, calls: int) -> float:
    """One run of `run` between CUDA events, per call of its `calls`."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _repeated(fn, reps: int):
    """`reps` back-to-back calls of fn, after one warm-up call."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return run


def _captured(fn, reps: int):
    """`reps` calls of fn captured in a CUDA graph, after one warm-up
    call; returns the graph's replay. Timing a replay leaves the host's
    per-call cost, which back-to-back calls include whenever it exceeds
    the device's, out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph.replay


def _time_ms(fn, reps: int, runs: int = 5) -> float:
    """Median over `runs` of the mean time of `reps` back-to-back calls."""
    run = _repeated(fn, reps)
    return float(np.median([_timed_ms(run, reps) for _ in range(runs)]))


def _graph_time_ms(fn, reps: int, runs: int = 5) -> float:
    """Device time of one call: median over `runs` graph replays."""
    replay = _captured(fn, reps)
    return float(np.median([_timed_ms(replay, reps) for _ in range(runs)]))


def _turns_ms(fa, fb, reps: int, graph: bool, runs: int = 8):
    """Per-call times of fa and fb timed in turns (a, b, b, a, ...), so
    that drift in the host's or the card's clocks falls on both: medians
    over `runs` each, from graph replays or from back-to-back calls."""
    make = _captured if graph else _repeated
    ra, rb = make(fa, reps), make(fb, reps)
    ta, tb = [], []
    for i in range(runs):
        for run, out in (((ra, ta), (rb, tb)) if i % 2 == 0
                         else ((rb, tb), (ra, ta))):
            out.append(_timed_ms(run, reps))
    return float(np.median(ta)), float(np.median(tb))


# -- phase 3: kernels against their plain versions --------------------------

def _k1_inputs(num_keys: int, width: int, gen: torch.Generator):
    """Mean-sorted centroids as a flush hands them to K1: per row a count
    of weighted slots in [0, width] (row 0 empty, row 1 one centroid),
    positive sorted means (timer values), weights 1/rate for rates 1,
    0.5, 0.25, 0.1, and the per-key scalars consistent with them."""
    dev = torch.device("cuda")
    n = torch.randint(0, width + 1, (num_keys,), generator=gen, device=dev)
    n[0], n[1] = 0, 1
    live = torch.arange(width, device=dev)[None, :] < n[:, None]
    means = torch.empty((num_keys, width), device=dev).exponential_(
        0.05, generator=gen)
    means = torch.sort(torch.where(live, means, math.inf), dim=-1).values
    choices = torch.tensor([1.0, 2.0, 4.0, 10.0], device=dev)
    weights = choices[torch.randint(0, 4, (num_keys, width), generator=gen,
                                    device=dev)]
    sm = torch.where(live, means, 0.0).contiguous()
    sw = torch.where(live, weights, 0.0).contiguous()
    first = sm[:, 0]
    last = torch.gather(sm, 1, (n - 1).clamp(min=0)[:, None])[:, 0]
    empty = n == 0
    dmin = torch.where(empty, math.inf, first * 0.999)
    dmax = torch.where(empty, -math.inf, last * 1.001)
    drecip = torch.where(empty, 0.0, (sw / sm.clamp(min=1e-3)).sum(-1))
    extra = torch.rand((num_keys, 5), generator=gen, device=dev) * 100
    scal = torch.cat([dmin[:, None], dmax[:, None], drecip[:, None],
                      extra], dim=-1).contiguous()
    return sm, sw, scal


def _check_k1(card: str, width: int, gen) -> dict:
    from veneur_tpu_torch.ops import tdigest_flush as tf
    num_keys = 100_000  # ragged against any power-of-two tile
    sm, sw, scal = _k1_inputs(num_keys, width, gen)
    ps = torch.tensor(PS, dtype=torch.float32, device="cuda")
    got = tf.flush_packed_cuda(sm, sw, scal, ps)
    torch.cuda.synchronize()
    want = tf.flush_packed_plain(sm, sw, scal, ps)
    torch.cuda.synchronize()
    ok = torch.isclose(got, want, equal_nan=True, **K1_TOL)
    if not bool(ok.all()):
        bad = torch.nonzero(~ok)[:5].tolist()
        raise AssertionError(
            f"tdigest_flush W={width}: {int((~ok).sum())} values outside "
            f"rtol/atol {K1_TOL}, e.g. at {bad}: kernel "
            f"{[float(got[r, c]) for r, c in bad]} plain "
            f"{[float(want[r, c]) for r, c in bad]}")
    err = float(torch.nan_to_num(got - want, nan=0.0).abs().max())
    ms = _time_ms(lambda: tf.flush_packed_cuda(sm, sw, scal, ps), reps=20)
    plain_ms = _time_ms(lambda: tf.flush_packed_plain(sm, sw, scal, ps),
                        reps=3, runs=3)
    # per slot: a cumsum add, a multiply-add for the sum, a compare for n
    # and one per percentile
    return {"width": width, "num_keys": num_keys, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            **_bound(card, tf.bound_bytes(num_keys, width, len(PS)),
                     num_keys * width * (4 + len(PS)))}


def _check_k2(card: str, gen) -> dict:
    from veneur_tpu_torch.ops import hll_estimate as he
    num_rows = 16_384  # the dense-slot ladder rung
    regs = torch.randint(1, 52, (num_rows, he.M), generator=gen,
                         device="cuda", dtype=torch.int8)
    fill = torch.rand((num_rows, he.M), generator=gen, device="cuda") < 0.3
    regs = torch.where(fill, regs, torch.zeros_like(regs)).contiguous()
    del fill
    regs[0] = 0  # an empty row estimates 0
    got = he.estimate_cuda(regs)
    torch.cuda.synchronize()
    want = he.estimate_plain(regs)
    torch.cuda.synchronize()
    if not bool(torch.isclose(got, want, rtol=K2_RTOL, atol=0.0).all()):
        raise AssertionError("hll_estimate disagrees with its plain version")
    if float(got[0]) != 0.0:
        raise AssertionError("hll_estimate: an empty row must estimate 0")
    err = float((got - want).abs().max())
    ms = _time_ms(lambda: he.estimate_cuda(regs), reps=20)
    plain_ms = _time_ms(lambda: he.estimate_plain(regs), reps=2, runs=3)
    # per register: compare, power of two, add
    return {"num_rows": num_rows, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
            **_bound(card, he.bound_bytes(num_rows), num_rows * he.M * 3)}


K3_KEYS = 65_536      # phase B's llhist_capacity
K3_LIVE_ROWS = 35_000  # phase B's llhist keys (timers and `|l` keys)
K3_CHUNK = 65_536      # ingest_batch_max_samples: one pump chunk


def _k3_batches():
    """K3's inputs, made with numpy from seeds: (a) a full pending buffer
    of 8192 uniform samples; (b) 65 536 samples on 16 hot keys whose
    values cluster like latencies; (c) a pump chunk at phase B's shape,
    65 536 samples over 35 000 rows, uniform over the 4501 live bins;
    (d) 2048 keys x 32 consecutive samples each, values lognormal per
    key, the order of a client's buffered packets. (a) and (c) carry
    padding and out-of-range rows and bins."""
    from veneur_tpu_torch.ops import batch_llhist, llhist_ref
    rng = np.random.default_rng(3)

    def uniform(n, live_rows, pad):
        """PAD_ROW padding at the end, 64 rows past the table and 64 bins
        past the padded width at the front, as a pending buffer holds."""
        rows = rng.integers(0, live_rows, n).astype(np.int32)
        bins = rng.integers(0, batch_llhist.BINS, n).astype(np.int32)
        wts = rng.integers(1, 3, n).astype(np.int32)
        rows[-pad:] = PAD_ROW
        rows[:64] = K3_KEYS + np.arange(64, dtype=np.int32)
        bins[64:128] = batch_llhist.BINS_PAD + 7
        return rows, bins, wts

    m = 65_536
    hot = (rng.integers(0, 16, m).astype(np.int32),
           llhist_ref.bin_index(rng.lognormal(3.0, 0.6, m)).astype(np.int32),
           np.ones(m, np.int32))
    keys = rng.choice(K3_LIVE_ROWS, 2048, replace=False).astype(np.int32)
    mu = rng.uniform(0.0, 7.0, 2048)  # 1 ms .. 1 s medians
    vals = rng.lognormal(mu[:, None], 0.3, (2048, 32))
    ordered = (np.repeat(keys, 32),
               llhist_ref.bin_index(vals.ravel()).astype(np.int32),
               np.ones(2048 * 32, np.int32))
    cases = {"uniform": uniform(8192, K3_KEYS, 256), "hot_keys": hot,
             "pump_chunk": uniform(K3_CHUNK, K3_LIVE_ROWS, 1024),
             "sender_ordered": ordered}
    return {label: tuple(torch.from_numpy(c).cuda() for c in cols)
            for label, cols in cases.items()}


def _check_k3(card: str, gen) -> dict:
    from veneur_tpu_torch.ops import llhist_apply as la
    base = torch.randint(0, 1000, (K3_KEYS, la.BINS_PAD), generator=gen,
                         device="cuda", dtype=torch.int32)
    out = {}
    cases = _k3_batches()
    for label, (rows, bins, wts) in cases.items():
        got, want = base.clone(), base.clone()
        la.apply_cuda(got, rows, bins, wts)
        torch.cuda.synchronize()
        la.apply_plain(want, rows, bins, wts)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"llhist_apply ({label}) differs from its "
                                 f"plain version")
        err = float((got - want).abs().max())
        del got, want
        keep = ((rows >= 0) & (rows < K3_KEYS) & (bins >= 0)
                & (bins < la.BINS_PAD))
        flat = rows[keep].long() * la.BINS_PAD + bins[keep].long()
        kept_wts = wts[keep]
        regs = base.clone()
        # device time from graph replays and the eager per-call time
        # (which the host's cost sets at these sizes), each in turns
        # with index_add_'s
        def kernel():
            la.apply_cuda(regs, rows, bins, wts)

        def library():  # the one-call yardstick, on inputs already masked
            regs.view(-1).index_add_(0, flat, kept_wts)

        ms, library_ms = _turns_ms(kernel, library, 100, graph=True)
        eager_ms, library_eager_ms = _turns_ms(kernel, library, 100,
                                               graph=False)
        # the plain version's boolean masks synchronise: eager only
        plain_ms = _time_ms(lambda: la.apply_plain(regs, rows, bins, wts),
                            reps=10, runs=3)
        one = (torch.zeros_like(rows[:1]), bins[:1], wts[:1])
        one_sample_ms = _graph_time_ms(lambda: la.apply_cuda(regs, *one),
                                       reps=100)
        registers = int(torch.unique(flat).numel())
        del regs
        out[label] = {"keys": K3_KEYS, "samples": int(rows.numel()),
                      "kept": int(keep.sum()), "registers": registers,
                      "max_abs_err": err, "ms": ms,
                      "eager_ms": eager_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms,
                      "library_eager_ms": library_eager_ms,
                      "one_sample_launch_ms": one_sample_ms,
                      **_bound(card, la.bound_bytes(rows.numel(), registers),
                               int(keep.sum()))}
    rows, bins, wts = cases["uniform"]
    out["launch_path_us"] = _k3_launch_path_us(rows, bins, wts, base)
    del base
    out["table_route"] = _check_k3_table_route()
    out["stress"] = _check_k3_stress()
    return out


def _k3_host_chunk(rng, n: int):
    from veneur_tpu_torch.ops import batch_llhist
    return (rng.integers(0, K3_LIVE_ROWS, n).astype(np.int32),
            rng.integers(0, batch_llhist.BINS, n).astype(np.int32),
            rng.integers(1, 3, n).astype(np.int32))


def _check_k3_table_route(reps: int = 20) -> dict:
    """One 65 536-sample host chunk into LLHistTable.add_batch_binned
    (one packed block, one copy, one launch), timed to a synchronise,
    beside the per-batch route written out (8 pieces of 8192, each three
    pageable copies and one launch) and, as the yardstick of the staging
    choice, the packed block's copy and launch alone from pageable memory
    (the port's) and from a pinned buffer. In turns (forward, then
    backward); every table must end equal."""
    from veneur_tpu_torch.core.columnstore import LLHistTable
    from veneur_tpu_torch.ops import batch_llhist
    from veneur_tpu_torch.ops import llhist_apply as la
    dev = torch.device("cuda")
    chunk = _k3_host_chunk(np.random.default_rng(11), K3_CHUNK)
    table = LLHistTable(dev, K3_KEYS, batch_cap=8192)
    regs = {name: torch.zeros_like(table.state)
            for name in ("per_batch", "pageable_block", "pinned_block")}
    pinned = torch.empty((3, K3_CHUNK), dtype=torch.int32, pin_memory=True)

    def per_batch():
        for i in range(0, K3_CHUNK, 8192):
            la.apply_cuda(regs["per_batch"],
                          *(torch.from_numpy(c[i:i + 8192]).to(dev)
                            for c in chunk))

    def pinned_block():
        pinned.numpy()[:] = batch_llhist.pack([chunk])
        la.apply_cuda(regs["pinned_block"],
                      *pinned.to(dev, non_blocking=True))

    routes = {"table": lambda: table.add_batch_binned(*chunk),
              "per_batch": per_batch,
              "pageable_block": lambda: batch_llhist.apply_packed(
                  regs["pageable_block"], batch_llhist.pack([chunk])),
              "pinned_block": pinned_block}
    names = list(routes)
    times = {name: [] for name in names}
    host = {name: [] for name in names}  # until the call returns
    launches = {name: [] for name in names}
    for i in range(reps):
        for name in (names if i % 2 == 0 else names[::-1]):
            before = la.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routes[name]()
            host[name].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            launches[name].append(la.launches - before)
    table.apply_pending()
    torch.cuda.synchronize()
    if table._n or any(not torch.equal(table.state, r)
                       for r in regs.values()):
        raise AssertionError("LLHistTable's route, the per-batch route and "
                             "the block copies left different tables")
    if set(launches["table"]) != {1}:
        raise AssertionError(f"a 65 536-sample chunk took "
                             f"{launches['table']} launches, not one")
    return {"samples": K3_CHUNK, "calls": reps,
            "ms": {name: float(np.median(times[name])) for name in names},
            "host_ms": {name: float(np.median(host[name]))
                        for name in names},
            "launches_per_chunk": {name: launches[name][0]
                                   for name in names}}


def _check_k3_stress(calls: int = 256, n: int = 20_000) -> dict:
    """Back-to-back add_batch_binned calls of distinct 20 000-sample
    chunks, then apply_pending(): the table must equal the plain version
    over the concatenation."""
    from veneur_tpu_torch.core.columnstore import LLHistTable
    from veneur_tpu_torch.ops import llhist_apply as la
    dev = torch.device("cuda")
    rows, bins, wts = _k3_host_chunk(np.random.default_rng(12), calls * n)
    table = LLHistTable(dev, K3_KEYS, batch_cap=8192)
    before = la.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, calls * n, n):
        table.add_batch_binned(rows[i:i + n], bins[i:i + n], wts[i:i + n])
    table.apply_pending()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = torch.zeros_like(table.state)
    la.apply_plain(want, *(torch.from_numpy(c).to(dev)
                           for c in (rows, bins, wts)))
    if not torch.equal(table.state, want):
        raise AssertionError("stress: the table differs from the plain "
                             "version over the concatenation")
    return {"calls": calls, "samples": calls * n,
            "launches": la.launches - before, "seconds": seconds}


def _k3_launch_path_us(rows, bins, wts, regs, calls: int = 5000) -> dict:
    """Host microseconds per call of the launch path's pieces: the
    wrapper's checks, the public current-stream accessor against the raw
    one it uses, and the current-device lookup."""
    from veneur_tpu_torch.ops import llhist_apply as la
    pieces = {
        "check": lambda: la._check(regs, rows, bins, wts, kernel=True),
        "current_stream": lambda: torch.cuda.current_stream(0).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "current_device": torch.cuda.current_device}
    out = {}
    for name, fn in pieces.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


# -- the server phases -------------------------------------------------------

DGRAM_BYTES = 1400
# lines in flight: a pump's rings hold 4 x 65 536 samples per reader, but
# when slow-path lines stall its dispatcher the socket buffers take the
# rest, so the window is also held to half of what the receive buffers
# the kernel granted can queue (a queued datagram costs its length plus
# ~800 bytes, ~45 bytes per line); a Python reader drains its socket
# between batches, as in slice 1
PUMP_WINDOW = 40_000
PY_WINDOW = 1_500
_QUEUED_BYTES_PER_LINE = 45


def _corpus(seed: int, keys: dict, ll_keys: int = 0):
    """One interval's phase A/C lines (shuffled), the expected counter
    and gauge series, the sorted timer samples, and the `|l` samples."""
    rng = np.random.default_rng(seed)
    lines = []
    expect = {}
    cvals = rng.integers(1, 1000, keys["counter"])
    crates = rng.choice([1.0, 0.5], keys["counter"])
    for k in range(keys["counter"]):
        lines.append(f"smoke.c{k}:{cvals[k]}|c|@{crates[k]}")
        expect[f"smoke.c{k}"] = float(math.trunc(cvals[k] / crates[k]))
    gtext = np.char.mod("%.3f", rng.normal(0, 100, (keys["gauge"], 2)))
    for k in range(keys["gauge"]):
        for v in gtext[k]:
            lines.append(f"smoke.g{k}:{v}|g")
    tvals = rng.gamma(2.0, 25.0, (keys["timer"], keys["timer_samples"]))
    ttext = np.char.mod("%.3f", tvals)
    for k in range(keys["timer"]):
        for v in ttext[k]:
            lines.append(f"smoke.t{k}:{v}|ms")
    for k in range(keys["set"]):
        for j in range(keys["set_members"]):
            lines.append(f"smoke.s{k}:u{seed}-{k}-{j}|s")
    llhists = _llhist_lines(rng, lines, "smoke.l", ll_keys, 32)
    order = rng.permutation(len(lines))
    lines = [lines[i] for i in order]
    # gauges: the value of each key's later line in send order wins
    last = {}
    for line in lines:
        if line.startswith("smoke.g"):
            name, rest = line.split(":", 1)
            last[name] = float(np.float32(float(rest.split("|", 1)[0])))
    expect.update(last)
    timers = np.sort(ttext.astype(np.float64).astype(np.float32), axis=1)
    return lines, expect, timers, llhists


def _llhist_lines(rng, lines: list, prefix: str, num_keys: int,
                  samples: int):
    """Append `|l` lines: values spread log-uniformly over 1e-3..1e6,
    one key in fifty with a value outside the bin window, rates 1 and
    0.5. Returns (name prefix, values as parsed, per-key weights)."""
    vals = 10.0 ** rng.uniform(-3, 6, (num_keys, samples))
    vals[::50, 0] = 1e-12
    vals[1::50, 0] = 3e16
    text = np.char.mod("%.6g", vals)
    rates = np.where(np.arange(num_keys) % 2, 0.5, 1.0)
    for k in range(num_keys):
        tail = "|l|@0.5" if rates[k] == 0.5 else "|l"
        lines.extend(f"{prefix}{k}:{v}{tail}" for v in text[k])
    return prefix, text.astype(np.float64), np.rint(1.0 / rates)


def _phase_b_corpus(seed: int):
    """Phase B: circllhist timers, explicit `|l` keys and counters."""
    keys = PHASE_B_KEYS
    rng = np.random.default_rng(seed)
    lines, expect = [], {}
    cvals = rng.integers(1, 1000, keys["counter"])
    crates = rng.choice([1.0, 0.5], keys["counter"])
    for k in range(keys["counter"]):
        lines.append(f"cl.c{k}:{cvals[k]}|c|@{crates[k]}")
        expect[f"cl.c{k}"] = float(math.trunc(cvals[k] / crates[k]))
    ttext = np.char.mod("%.3f", rng.gamma(
        2.0, 25.0, (keys["timer"], keys["timer_samples"])))
    for k in range(keys["timer"]):
        lines.extend(f"cl.t{k}:{v}|ms" for v in ttext[k])
    timers = ("cl.t", ttext.astype(np.float64), np.ones(keys["timer"]))
    ll = _llhist_lines(rng, lines, "cl.l", keys["llhist"],
                       keys["llhist_samples"])
    order = rng.permutation(len(lines))
    return [lines[i] for i in order], expect, [timers, ll]


def _set_reference(seed: int, num_keys: int, members: int,
                   more_seeds=()) -> np.ndarray:
    """The reference HLL's estimate per key over members u<seed>-<k>-<j>,
    j < members, of `seed` and each of `more_seeds`."""
    from veneur_tpu_torch.ops import hll_ref
    est = np.empty(num_keys)
    for k in range(num_keys):
        h = hll_ref.HLL()
        for s in (seed, *more_seeds):
            for j in range(members):
                h.insert(f"u{s}-{k}-{j}".encode())
        est[k] = hll_ref.estimate_from_registers(h.regs)
    return est


def _datagrams(lines):
    out, cur, size, counts = [], [], 0, []
    for line in lines:
        b = line.encode()
        if cur and size + len(b) + 1 > DGRAM_BYTES:
            out.append(b"\n".join(cur))
            counts.append(len(cur))
            cur, size = [], 0
        cur.append(b)
        size += len(b) + 1
    out.append(b"\n".join(cur))
    counts.append(len(cur))
    return out, counts


def _send(server, addr, lines, base: int, window: int,
          senders: int = 1) -> float:
    """Send paced by the server's received-line count, so loopback drops
    nothing, round-robin over `senders` sockets; returns when every line
    has been received (or raises)."""
    dgrams, counts = _datagrams(lines)
    sent = base
    t0 = time.perf_counter()
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(senders)]
    try:
        for i, (dgram, n) in enumerate(zip(dgrams, counts)):
            deadline = time.monotonic() + 30.0
            while sent - server.stats["lines_received"] > window:
                if time.monotonic() > deadline:
                    raise AssertionError("server stopped receiving lines")
                time.sleep(0.0005)
            socks[i % senders].sendto(dgram, addr)
            sent += n
    finally:
        for s in socks:
            s.close()
    deadline = time.monotonic() + 60.0
    while server.stats["lines_received"] < sent:
        if time.monotonic() > deadline:
            raise AssertionError(
                f"lines lost on loopback: sent {sent}, received "
                f"{server.stats['lines_received']}")
        time.sleep(0.001)
    return time.perf_counter() - t0


def _k_scale(q):
    return 100.0 * (np.arcsin(2.0 * np.clip(q, 0, 1) - 1.0) / math.pi + 0.5)


def _q_of_k(k):
    return (np.sin((np.clip(k, 0, 100) / 100.0 - 0.5) * math.pi) + 1.0) / 2.0


def _check_exact(got: dict, expect: dict) -> None:
    missing = [name for name in expect if name not in got]
    if missing:
        raise AssertionError(f"{len(missing)} series missing, e.g. "
                             f"{missing[:3]}")
    wrong = [(n, v, got[n]) for n, v in expect.items() if got[n] != v]
    if wrong:
        raise AssertionError(f"{len(wrong)} counter/gauge series wrong, "
                             f"e.g. {wrong[:3]}")


def _check_timers(got: dict, timers: np.ndarray, aggregates: bool = True,
                  percentiles: bool = True) -> int:
    """Timer series of the keys `smoke.t<k>` against their sorted samples:
    min/max/count exactly, p50/p99 within the t-digest's rank slack."""
    n = timers.shape[1]
    t = np.arange(timers.shape[0])
    if aggregates:
        for suffix, want in (("min", timers[:, 0]), ("max", timers[:, -1])):
            vals = np.array([got[f"smoke.t{k}.{suffix}"] for k in t])
            if not np.array_equal(vals, want.astype(np.float64)):
                raise AssertionError(f"timer {suffix} differs")
        counts = np.array([got[f"smoke.t{k}.count"] for k in t])
        if not (counts == n).all():
            raise AssertionError("timer counts differ")
    for p, label in (((0.5, "50"), (0.99, "99")) if percentiles else ()):
        # the t-digest's slack: one k-unit either side of p on the
        # arcsine scale, widened by one sample for the interpolation
        # between neighbouring centroids' midpoints
        lo = np.maximum(np.floor(n * _q_of_k(_k_scale(p) - 1)) - 1, 0)
        hi = np.minimum(np.ceil(n * _q_of_k(_k_scale(p) + 1)), n - 1)
        vals = np.array([got[f"smoke.t{k}.{label}percentile"] for k in t])
        eps = 1e-5 * np.abs(vals) + 1e-4
        below = vals < timers[:, int(lo)] - eps
        above = vals > timers[:, int(hi)] + eps
        if below.any() or above.any():
            raise AssertionError(f"timer p{label} outside its slack for "
                                 f"{int(below.sum() + above.sum())} keys")
    return timers.shape[0] * (3 * aggregates + 2 * percentiles)


def _check_sets(got: dict, set_ref: np.ndarray, members: int,
                slack: int = 1) -> dict:
    est = np.array([got[f"smoke.s{k}"] for k in range(set_ref.shape[0])])
    if not np.array_equal(est, set_ref):
        raise AssertionError(
            f"set estimates differ from the reference HLL for "
            f"{int((est != set_ref).sum())} keys")
    # the reference estimator rounds floor(x + 1) (hyperloglog.go:225-231
    # parity), so allow its +1 (slack) on top of 2 %
    if not (np.abs(est - members) <= 0.02 * members + slack).all():
        raise AssertionError(f"set estimate beyond 2 % + {slack} of the "
                             f"truth")
    return {"set_mean_rel_err": float(np.mean(np.abs(est - members))
                                      / members)}


def _fmt_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else format(bound, ".12g")


def _check_llhists(got: dict, buckets: dict, prefix: str,
                   vals: np.ndarray, weights: np.ndarray) -> int:
    """Every series of the llhist keys `<prefix><k>` against a host
    reference built with llhist_ref from exactly the values sent:
    `.count` and every `.bucket` line exactly, `.sum` against the bins'
    midpoint sum, each percentile against llhist_ref.quantiles and
    within one bin of the sample quantile. Returns series checked."""
    from veneur_tpu_torch.ops import llhist_ref as ref
    num_keys, samples = vals.shape
    bins = ref.bin_index(vals.ravel()).reshape(num_keys, samples)
    rank = np.empty(ref.BINS, np.int64)
    rank[ref.ORDER] = np.arange(ref.BINS)  # bin id -> value-sorted slot
    codes = np.arange(num_keys)[:, None] * ref.BINS + rank[bins]
    uniq, per = np.unique(codes.ravel(), return_counts=True)
    key_of, slot = uniq // ref.BINS, uniq % ref.BINS
    w = per * weights[key_of].astype(np.int64)
    starts = np.flatnonzero(np.r_[True, key_of[1:] != key_of[:-1]])
    totals = np.add.reduceat(w, starts)
    cum = np.cumsum(w) - np.repeat(np.cumsum(w)[starts] - w[starts],
                                   np.diff(np.r_[starts, w.size]))
    sums = np.add.reduceat(w * ref.MID_SORTED[slot], starts)
    inv_cdf = np.quantile(vals, PS, axis=1, method="inverted_cdf").T
    checked = 0
    bad = []
    for k in range(num_keys):
        name = f"{prefix}{k}"
        lo, hi = starts[k], (starts[k + 1] if k + 1 < num_keys else w.size)
        want_b = {f"le:{_fmt_le(ref.UPPER_SORTED[s])}": float(c)
                  for s, c in zip(slot[lo:hi].tolist(), cum[lo:hi].tolist())}
        want_b["le:+Inf"] = float(totals[k])
        if buckets.get(f"{name}.bucket") != want_b:
            bad.append((name, "bucket"))
        if got.get(f"{name}.count") != float(totals[k]):
            bad.append((name, "count"))
        if not math.isclose(got.get(f"{name}.sum", math.nan), sums[k],
                            rel_tol=1e-12, abs_tol=1e-9):
            bad.append((name, "sum"))
        dense = np.zeros(ref.BINS, np.int64)
        dense[ref.ORDER[slot[lo:hi]]] = w[lo:hi]
        want_q = ref.quantiles(dense, PS)
        for j, p in enumerate(PS):
            q = got.get(f"{name}.{int(p * 100)}percentile", math.nan)
            if not math.isclose(q, want_q[j], rel_tol=LL_RTOL,
                                abs_tol=1e-12):
                bad.append((name, p, q, want_q[j]))
            x = inv_cdf[k, j]
            if not ref.clamped_mask(x):
                width = ref.BIN_WIDTH[ref.bin_index(x)]
                if abs(q - x) > width * (1 + 1e-6) + 1e-9 * abs(x):
                    bad.append((name, p, q, "sample quantile", x))
        checked += len(want_b) + 2 + len(PS)
    if bad:
        raise AssertionError(f"{len(bad)} llhist series wrong, e.g. "
                             f"{bad[:3]}")
    return checked


def _collect(sink) -> tuple:
    """The flushed series by name, and the `.bucket` lines by name and
    `le:` tag."""
    got, buckets = {}, {}
    for m in sink.wait_flush(timeout=600):
        if m.name.endswith(".bucket"):
            le = next(t for t in m.tags if t.startswith("le:"))
            buckets.setdefault(m.name, {})[le] = m.value
        else:
            got[m.name] = m.value
    return got, buckets


def _server(cfg_extra: dict, tpu: dict, sink):
    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.core.server import Server
    cfg = config_from_dict({
        "statsd_listen_addresses": ["udp://127.0.0.1:0"],
        "interval": "1h",  # the smoke flushes by hand
        "percentiles": list(PS), "aggregates": ["min", "max", "count"],
        "read_buffer_size_bytes": 8 << 20, "hostname": "smoke",
        **cfg_extra, "tpu": {"batch_cap": 8192, **tpu}})
    return Server(cfg, extra_metric_sinks=[sink])  # cuda:0


def _zero_launches():
    from veneur_tpu_torch.ops import hll_estimate, llhist_apply, tdigest_flush
    for mod in (tdigest_flush, hll_estimate, llhist_apply):
        mod.launches = 0


def _read_launches() -> dict:
    from veneur_tpu_torch.ops import hll_estimate, llhist_apply, tdigest_flush
    return {"tdigest_flush": int(tdigest_flush.launches),
            "hll_estimate": int(hll_estimate.launches),
            "llhist_apply": int(llhist_apply.launches)}


def _run_phase(name: str, server, intervals, window: int, senders: int,
               check, path_kernels) -> dict:
    """Drive one server through its intervals: send, flush, check. The
    launch counts are zeroed just before and read just after."""
    _zero_launches()
    server.start()
    try:
        addr = server.listen_addresses[0]
        rcvbuf = sum(s.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
                     for s in server._listeners[0]._socks)
        window = min(window, rcvbuf // (2 * _QUEUED_BYTES_PER_LINE))
        report = {"intervals": [], "rcvbuf_bytes": rcvbuf,
                  "window_lines": window}
        base = 0
        seen = _read_launches()
        for corpus in intervals:
            lines = corpus[0]
            ingest_s = _send(server, addr, lines, base, window, senders)
            base += len(lines)
            stats = server.stats_snapshot()
            if stats["lines_received"] != base:
                raise AssertionError(f"{name}: sent {base} lines, received "
                                     f"{stats['lines_received']}")
            if stats["ingest_dispatch_errors"]:
                raise AssertionError(f"{name}: ingest dispatch errors "
                                     f"{stats}")
            server.flush()
            now = _read_launches()
            got, buckets = _collect(server.metric_sinks[0])
            report["intervals"].append({
                "lines": len(lines), "ingest_s": ingest_s,
                "lines_per_s": len(lines) / ingest_s,
                "flush": dict(server.last_flush_timings),
                "launches": {k: now[k] - seen[k] for k in now},
                **check(corpus, got, buckets)})
            seen = now
    finally:
        server.shutdown()
    report["launches"] = _read_launches()
    stats = server.stats_snapshot()
    report["stats"] = stats
    if stats["lines_rejected"] or stats["unknown_rejected"] \
            or stats["ingest_dispatch_errors"]:
        raise AssertionError(f"{name}: lines rejected: {stats}")
    for kernel in path_kernels:
        if report["launches"][kernel] <= 0:
            raise AssertionError(f"{name}: {kernel} was not launched by the "
                                 f"server")
    return report


PHASE_A_KEYS = {"counter": 40_000, "gauge": 20_000, "timer": 30_000,
                "timer_samples": 16, "set": 10_000, "set_members": 32}
PHASE_C_KEYS = {k: (v // 10 if k not in ("timer_samples", "set_members")
                    else v) for k, v in PHASE_A_KEYS.items()}
PHASE_C_LL_KEYS = 500
PHASE_B_KEYS = {"counter": 20_000, "timer": 30_000, "timer_samples": 16,
                "llhist": 5_000, "llhist_samples": 32}


def _check_a_or_c(keys: dict):
    def check(corpus, got, buckets) -> dict:
        _lines, expect, timers, llhists, set_ref = corpus
        _check_exact(got, expect)
        checked = len(expect) + _check_timers(got, timers)
        out = _check_sets(got, set_ref, keys["set_members"])
        if llhists[1].size:
            checked += _check_llhists(got, buckets, *llhists)
        return {"series_checked": checked + keys["set"], **out}
    return check


def _phase_a() -> dict:
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    corpora = [_corpus(seed, PHASE_A_KEYS) + (_set_reference(
        seed, PHASE_A_KEYS["set"], PHASE_A_KEYS["set_members"]),)
        for seed in (1, 2)]
    server = _server({}, {"counter_capacity": 65536,
                          "gauge_capacity": 32768, "histo_capacity": 32768,
                          "set_capacity": 16384}, ChannelMetricSink())
    return _run_phase("phase A", server, corpora, PUMP_WINDOW, 1,
                      _check_a_or_c(PHASE_A_KEYS),
                      ("tdigest_flush", "hll_estimate"))


def _phase_b() -> dict:
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    corpora = [_phase_b_corpus(seed) for seed in (3, 4)]
    server = _server({"histogram_encoding": "circllhist", "num_readers": 2},
                     {"counter_capacity": 32768, "llhist_capacity": 65536},
                     ChannelMetricSink())

    def check(corpus, got, buckets) -> dict:
        _lines, expect, llhists = corpus
        _check_exact(got, expect)
        checked = len(expect)
        for prefix, vals, weights in llhists:
            checked += _check_llhists(got, buckets, prefix, vals, weights)
        return {"series_checked": checked}
    return _run_phase("phase B", server, corpora, PUMP_WINDOW, 8, check,
                      ("llhist_apply",))


def _phase_c() -> dict:
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    corpora = [_corpus(seed, PHASE_C_KEYS, PHASE_C_LL_KEYS) + (_set_reference(
        seed, PHASE_C_KEYS["set"], PHASE_C_KEYS["set_members"]),)
        for seed in (5, 6)]
    server = _server({}, {"counter_capacity": 8192, "gauge_capacity": 4096,
                          "histo_capacity": 4096, "set_capacity": 2048,
                          "llhist_capacity": 1024,
                          "disable_native_parser": True},
                     ChannelMetricSink())
    return _run_phase("phase C", server, corpora, PY_WINDOW, 1,
                      _check_a_or_c(PHASE_C_KEYS),
                      ("tdigest_flush", "hll_estimate", "llhist_apply"))


PHASE_D_LL_KEYS = 5_000
# per local and interval: the global-only counter and gauge halves, every
# timer, set and llhist key
PHASE_D_FORWARDED = (PHASE_A_KEYS["counter"] // 2 + PHASE_A_KEYS["gauge"] // 2
                     + PHASE_A_KEYS["timer"] + PHASE_A_KEYS["set"]
                     + PHASE_D_LL_KEYS)


def _phase_d_corpus(seed: int, local: int):
    """One local's interval of phase D: phase A's key set, half of the
    counter keys and half of the gauge keys global-only (the global-only
    gauge names carry the local's index, so each is sent by one local),
    set members j in [16 local, 16 local + 32) (the two locals overlap by
    half), and PHASE_D_LL_KEYS `|l` keys x 32. Returns the lines, the
    series the local flushes (mixed counters and gauges), the global-only
    counters and gauges, the sorted timer samples and the llhist values."""
    keys = PHASE_A_KEYS
    rng = np.random.default_rng(100 * seed + local)
    lines, local_expect, global_expect = [], {}, {}
    half = keys["counter"] // 2
    cvals = rng.integers(1, 1000, keys["counter"])
    crates = rng.choice([1.0, 0.5], keys["counter"])
    for k in range(keys["counter"]):
        value = float(math.trunc(cvals[k] / crates[k]))
        if k < half:
            lines.append(f"smoke.fc{k}:{cvals[k]}|c|@{crates[k]}"
                         f"|#veneurglobalonly")
            global_expect[f"smoke.fc{k}"] = value
        else:
            lines.append(f"smoke.c{k}:{cvals[k]}|c|@{crates[k]}")
            local_expect[f"smoke.c{k}"] = value
    half = keys["gauge"] // 2
    gtext = np.char.mod("%.3f", rng.normal(0, 100, (keys["gauge"], 2)))
    for k in range(keys["gauge"]):
        name, tail = ((f"smoke.fg{local}.{k}", "|g|#veneurglobalonly")
                      if k < half else (f"smoke.g{k}", "|g"))
        lines.extend(f"{name}:{v}{tail}" for v in gtext[k])
    ttext = np.char.mod("%.3f", rng.gamma(
        2.0, 25.0, (keys["timer"], keys["timer_samples"])))
    for k in range(keys["timer"]):
        lines.extend(f"smoke.t{k}:{v}|ms" for v in ttext[k])
    members = range(16 * local, 16 * local + keys["set_members"])
    for k in range(keys["set"]):
        lines.extend(f"smoke.s{k}:u{seed}-{k}-{j}|s" for j in members)
    _prefix, ll_vals, ll_weights = _llhist_lines(
        rng, lines, "smoke.l", PHASE_D_LL_KEYS, 32)
    order = rng.permutation(len(lines))
    lines = [lines[i] for i in order]
    for line in lines:  # gauges: each key's later line in send order wins
        if line.startswith(("smoke.g", "smoke.fg")):
            name, rest = line.split(":", 1)
            value = float(np.float32(float(rest.split("|", 1)[0])))
            (global_expect if name.startswith("smoke.fg")
             else local_expect)[name] = value
    timers = np.sort(ttext.astype(np.float64).astype(np.float32), axis=1)
    return lines, local_expect, global_expect, timers, ll_vals, ll_weights


def _phase_d_interval(seed: int):
    """Both locals' corpora of one interval and the global's references:
    counters summed, gauges united, the timers' and llhists' samples
    joined, the set reference over the union's 48 members."""
    parts = [_phase_d_corpus(seed, local) for local in (0, 1)]
    global_expect = {}
    for part in parts:
        for name, value in part[2].items():
            global_expect[name] = global_expect.get(name, 0.0) + value \
                if name.startswith("smoke.fc") else value
    timers = np.sort(np.concatenate([p[3] for p in parts], axis=1), axis=1)
    ll_vals = np.concatenate([p[4] for p in parts], axis=1)
    set_ref = _set_reference(seed, PHASE_A_KEYS["set"],
                             16 + PHASE_A_KEYS["set_members"])
    return parts, (global_expect, timers, ll_vals, parts[0][5], set_ref)


def _pump_window(server) -> int:
    """Lines in flight to the server's pump that its sockets' receive
    buffers hold (PUMP_WINDOW at most)."""
    rcvbuf = sum(sk.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
                 for sk in server._listeners[0]._socks)
    return min(PUMP_WINDOW, rcvbuf // (2 * _QUEUED_BYTES_PER_LINE))


def _check_local(server, part, phase: str) -> int:
    """A local's own series of one interval: its mixed counters and
    gauges, timer min/max/count, and none of what it forwarded."""
    got, buckets = _collect(server.metric_sinks[0])
    _check_exact(got, part[1])
    leaked = [n for n in got if n.startswith(
        ("smoke.fc", "smoke.fg", "smoke.s", "smoke.l")) or "percentile" in n]
    if leaked or buckets:
        raise AssertionError(f"{phase} flushed forwarded series: "
                             f"{leaked[:3]}")
    return len(part[1]) + _check_timers(got, part[3], percentiles=False)


def _check_global(got: dict, buckets: dict, expect: dict,
                  timers: np.ndarray, ll_vals: np.ndarray, ll_w: np.ndarray,
                  set_ref: np.ndarray, members: int, phase: str,
                  aggregates: bool = False) -> dict:
    """A global's series of what the locals forwarded: counters and
    gauges exactly, timer percentiles (and min/max/count where
    `aggregates`) against the samples, set estimates against the
    reference HLL and within 2 % + 2 of the truth (at 48 members three of
    a set's members can share HLL registers, each shared one reading a
    member less), every llhist series, and none of the locals' mixed
    counters."""
    _check_exact(got, expect)
    checked = len(expect) + _check_timers(got, timers, aggregates=aggregates)
    out = _check_sets(got, set_ref, members, slack=2)
    checked += len(set_ref) + _check_llhists(got, buckets, "smoke.l",
                                             ll_vals, ll_w)
    if any(n.startswith("smoke.c") for n in got):
        raise AssertionError(f"{phase}: the global flushed the locals' "
                             f"mixed counters")
    return {"series_checked": checked, **out}


def _phase_d() -> dict:
    """The forward tier on the card: two local Servers on the native pump
    forward to one global Server over gRPC on 127.0.0.1, all on cuda:0.
    Per interval: ingest on both locals, flush both (the export flush and
    the forward send), check that the global imported both, flush it."""
    from veneur_tpu_torch.forward import convert
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    keys = PHASE_A_KEYS
    intervals = [_phase_d_interval(seed) for seed in (7, 8)]
    gserver = _server({"grpc_address": "127.0.0.1:0",
                       "statsd_listen_addresses": []},
                      {"counter_capacity": 32768, "gauge_capacity": 32768,
                       "histo_capacity": 32768, "set_capacity": 16384,
                       "llhist_capacity": 8192}, ChannelMetricSink())
    fallback_before = convert.proto_fallback_rows
    _zero_launches()
    gserver.start()
    locals_ = []
    try:
        imp = gserver.import_server
        for _ in range(2):
            server = _server({"forward_address": imp.address},
                             {"counter_capacity": 65536,
                              "gauge_capacity": 32768,
                              "histo_capacity": 32768,
                              "set_capacity": 16384,
                              "llhist_capacity": 8192}, ChannelMetricSink())
            server.start()
            locals_.append(server)
        windows = [_pump_window(server) for server in locals_]
        report = {"intervals": []}
        bases = [0, 0]
        seen = _read_launches()
        for parts, (g_expect, timers, ll_vals, ll_w, set_ref) in intervals:
            rec = {"ingest_s": [], "local_flush": [], "lines": []}
            for i, (server, part) in enumerate(zip(locals_, parts)):
                rec["ingest_s"].append(_send(
                    server, server.listen_addresses[0], part[0], bases[i],
                    windows[i]))
                bases[i] += len(part[0])
                rec["lines"].append(len(part[0]))
            for i, server in enumerate(locals_):
                stats = server.stats_snapshot()
                if (stats["lines_received"] != bases[i] or stats["lost_lines"]
                        or stats["ingest_dispatch_errors"]):
                    raise AssertionError(f"phase D local {i}: {stats}")
            merge_before = dict(imp.merge_s)
            bytes_before = imp.v1_bytes
            for server in locals_:
                server.flush()
                rec["local_flush"].append(dict(server.last_flush_timings))
            for i, server in enumerate(locals_):
                stats = server.stats_snapshot()
                if stats["forward_errors"]:
                    raise AssertionError(f"phase D local {i} forward "
                                         f"errors: {stats}")
            want_imported = sum(s.stats_snapshot()["forwarded_total"]
                                for s in locals_)
            if imp.imported_total != want_imported or imp.errors:
                raise AssertionError(
                    f"phase D: the global imported {imp.imported_total} "
                    f"metrics with {imp.errors} errors, the locals "
                    f"forwarded {want_imported}")
            rec["merge_s"] = {k: imp.merge_s[k] - merge_before[k]
                              for k in imp.merge_s}
            rec["v1_body_bytes"] = (imp.v1_bytes - bytes_before) / 2
            gserver.flush()
            rec["global_flush"] = dict(gserver.last_flush_timings)
            now = _read_launches()
            rec["launches"] = {k: now[k] - seen[k] for k in now}
            seen = now
            checked = 0
            for i, (server, part) in enumerate(zip(locals_, parts)):
                checked += _check_local(server, part, f"phase D local {i}")
                flow = server.forward_client.last_flow
                if flow != {"received": PHASE_D_FORWARDED,
                            "merged": PHASE_D_FORWARDED,
                            "duplicate": False}:
                    raise AssertionError(f"phase D local {i}: FlowCounts "
                                         f"{flow}")
            got, buckets = _collect(gserver.metric_sinks[0])
            rec.update(_check_global(got, buckets, g_expect, timers,
                                     ll_vals, ll_w, set_ref,
                                     16 + keys["set_members"], "phase D"))
            rec["series_checked"] += checked
            report["intervals"].append(rec)
    finally:
        for server in locals_:
            server.shutdown()
        gserver.shutdown()
    report["launches"] = _read_launches()
    report["stats"] = {"locals": [s.stats_snapshot() for s in locals_],
                       "global": gserver.stats_snapshot()}
    for i, stats in enumerate(report["stats"]["locals"]):
        if stats["forwarded_total"] != 2 * PHASE_D_FORWARDED:
            raise AssertionError(f"phase D local {i} forwarded "
                                 f"{stats['forwarded_total']}")
    if report["stats"]["global"]["imported_total"] != 4 * PHASE_D_FORWARDED:
        raise AssertionError(f"phase D: the global imported "
                             f"{report['stats']['global']}")
    report["proto_fallback_rows"] = \
        convert.proto_fallback_rows - fallback_before
    if report["proto_fallback_rows"]:
        raise AssertionError(f"phase D: {report['proto_fallback_rows']} "
                             f"rows took the proto fallback encoder")
    for kernel in ("tdigest_flush", "hll_estimate", "llhist_apply"):
        if report["launches"][kernel] <= 0:
            raise AssertionError(f"phase D: {kernel} was not launched")
    return report


PHASE_E_STALE = 0.001  # wal_stale_after_intervals: 3.6 s of the 1 h interval


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _restart_import(gserver, address: str) -> None:
    """A fresh import server for `gserver` at the address the stopped one
    held (a gRPC server does not start twice)."""
    from veneur_tpu_torch.forward.server import ImportServer
    gserver.import_server = ImportServer(gserver, address)
    gserver.import_server.start()
    if gserver.import_server.address != address:
        raise AssertionError(f"phase E: import server rebound to "
                             f"{gserver.import_server.address}, not {address}")


def _await_channel(server) -> float:
    """Wait (at most 30 s) until the local's channel to the restarted
    global is up again; returns the seconds waited. gRPC holds a channel
    that lost its peer in a reconnect backoff of up to 2 s, and the
    retry policy's three attempts (at most 0.6 s of backoff) can all
    fall inside it: the interval would then wait in the carryover for
    the next flush, lossless but outside this check."""
    import grpc
    t0 = time.perf_counter()
    grpc.channel_ready_future(server.forward_client._channel).result(
        timeout=30)
    return time.perf_counter() - t0


_LOCAL_TIMING_KEYS = ("total_s", "forward_encode_s", "forward_s",
                      "carryover_merge_s", "wal_append_s", "spool_drain_s")


def _phase_e_local(extra: dict, listen: bool = True):
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    cfg = {"carryover_max_intervals": 3, "forward_retry_max_attempts": 3,
           "circuit_breaker_failure_threshold": 3, **extra}
    if not listen:
        cfg["statsd_listen_addresses"] = []
    return _server(cfg, {"counter_capacity": 65536, "gauge_capacity": 32768,
                         "histo_capacity": 32768, "set_capacity": 16384,
                         "llhist_capacity": 8192}, ChannelMetricSink())


def _ingest_e(server, part, base: int) -> float:
    ingest_s = _send(server, server.listen_addresses[0], part[0], base,
                     _pump_window(server))
    stats = server.stats_snapshot()
    if (stats["lines_received"] != base + len(part[0]) or stats["lost_lines"]
            or stats["ingest_dispatch_errors"]):
        raise AssertionError(f"phase E local: {stats}")
    return ingest_s


def _phase_e() -> dict:
    """Forward resilience on the card. E1: one local (phase D's per-local
    key set, on the pump) and one global at a fixed 127.0.0.1 port, all
    on cuda:0; the global's import server is down for interval 2 and back
    at the same address for interval 3, whose one send carries intervals
    2 and 3 merged by the carryover. E2: a local with `forward_wal: true`
    appends its interval while the global is down, is shut down, and a
    fresh local on the same spool replays it to the restarted global,
    which files it in its backfill plane under the original interval;
    the segment put back after its replay replays again and is
    deduplicated."""
    import shutil
    import tempfile
    from veneur_tpu_torch.forward import convert
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    keys = PHASE_A_KEYS
    members = keys["set_members"]
    address = f"127.0.0.1:{_free_port()}"
    gserver = _server({"grpc_address": address, "statsd_listen_addresses": [],
                       "wal_stale_after_intervals": PHASE_E_STALE},
                      {"counter_capacity": 32768, "gauge_capacity": 32768,
                       "histo_capacity": 32768, "set_capacity": 16384,
                       "llhist_capacity": 8192}, ChannelMetricSink())
    local = _phase_e_local({"forward_address": address})
    spool_dir = tempfile.mkdtemp(prefix="smoke-wal-")
    wal_cfg = {"forward_address": address, "forward_wal": True,
               "carryover_spool_dir": spool_dir,
               "wal_stale_after_intervals": PHASE_E_STALE}
    fallback_before = convert.proto_fallback_rows
    report = {"intervals": []}
    started = [gserver]
    _zero_launches()
    gserver.start()
    try:
        local.start()
        started.append(local)
        seen = _read_launches()
        parts = {seed: _phase_d_corpus(seed, 0) for seed in (11, 12, 13)}
        base = 0
        # -- E1: an outage the carryover absorbs ----------------------------
        for i, seed in enumerate((11, 12, 13)):
            part = parts[seed]
            rec = {"interval": f"E1.{i + 1}", "lines": len(part[0])}
            if i == 1:
                gserver.import_server.stop()
            if i == 2:
                _restart_import(gserver, address)
            rec["ingest_s"] = _ingest_e(local, part, base)
            base += len(part[0])
            if i == 2:
                rec["channel_wait_s"] = _await_channel(local)
            imp = gserver.import_server
            merge_before = dict(imp.merge_s)
            retries_before = local.stats_snapshot()["forward_retries"]
            local.flush()
            rec["local_flush"] = {k: local.last_flush_timings.get(k, 0.0)
                                  for k in _LOCAL_TIMING_KEYS}
            stats = local.stats_snapshot()
            rec["retries"] = stats["forward_retries"] - retries_before
            rec["checked_local"] = _check_local(local, part, "phase E1")
            if i == 1:
                if (stats["forward_errors"] != 1 or rec["retries"] < 1
                        or stats["carryover_depth"] != 1
                        or stats["carryover_pending"] != PHASE_D_FORWARDED
                        or stats["carryover_shed"]):
                    raise AssertionError(f"phase E1 outage: {stats}")
                rec["stats"] = stats
                report["intervals"].append(rec)
                continue
            flow = local.forward_client.last_flow
            if (flow != {"received": PHASE_D_FORWARDED,
                         "merged": PHASE_D_FORWARDED, "duplicate": False}
                    or imp.imported_total != PHASE_D_FORWARDED or imp.errors
                    or stats["forward_errors"] != (1 if i else 0)):
                raise AssertionError(f"phase E1 interval {i + 1}: flow "
                                     f"{flow}, imported {imp.imported_total}"
                                     f", {stats}")
            if i == 2 and (stats["carryover_merged"] != PHASE_D_FORWARDED
                           or stats["carryover_shed"]
                           or stats["carryover_depth"]):
                raise AssertionError(f"phase E1 recovery: {stats}")
            rec["merge_s"] = {k: imp.merge_s[k] - merge_before[k]
                              for k in imp.merge_s}
            rec["v1_body_bytes"] = imp.v1_bytes
            gserver.flush()
            rec["global_flush"] = dict(gserver.last_flush_timings)
            got, buckets = _collect(gserver.metric_sinks[0])
            if i == 0:
                rec.update(_check_global(
                    got, buckets, part[2], part[3], part[4], part[5],
                    _set_reference(seed, keys["set"], members), members,
                    "phase E1"))
            else:
                # the union of intervals 2 and 3: counters summed, gauges
                # interval 3's, samples and set members of both
                old = parts[12]
                expect = dict(part[2])
                for name, value in old[2].items():
                    if name.startswith("smoke.fc"):
                        expect[name] += value
                rec.update(_check_global(
                    got, buckets, expect,
                    np.sort(np.concatenate([old[3], part[3]], axis=1),
                            axis=1),
                    np.concatenate([old[4], part[4]], axis=1), part[5],
                    _set_reference(12, keys["set"], members, (13,)),
                    2 * members, "phase E1"))
            rec["stats"] = stats
            report["intervals"].append(rec)
        report["e1_launches"] = {k: v - seen[k]
                                 for k, v in _read_launches().items()}
        # -- E2: a crash that the WAL replays --------------------------------
        seen = _read_launches()
        part = _phase_d_corpus(14, 0)
        rec = {"interval": "E2", "lines": len(part[0])}
        gserver.import_server.stop()
        wal_local = _phase_e_local(wal_cfg)
        wal_local.start()
        started.append(wal_local)
        rec["ingest_s"] = _ingest_e(wal_local, part, 0)
        wal_local.flush()
        rec["local_flush"] = {k: wal_local.last_flush_timings.get(k, 0.0)
                              for k in _LOCAL_TIMING_KEYS}
        rec["checked_local"] = _check_local(wal_local, part, "phase E2")
        stats = wal_local.stats_snapshot()
        spool = wal_local.forward_client.spool
        seg = spool.oldest()
        if (stats["wal_appended"] != PHASE_D_FORWARDED
                or stats["spool_depth"] != 1 or stats["wal_acked"]
                or stats["forward_errors"] != 1 or seg is None):
            raise AssertionError(f"phase E2 append: {stats}")
        rec["segment_bytes"] = seg.nbytes
        stamp = seg.interval_unix
        wal_local.shutdown()  # the crash: the send never landed
        started.remove(wal_local)
        fresh = _phase_e_local(wal_cfg, listen=False)
        fresh.start()
        started.append(fresh)
        spool = fresh.forward_client.spool
        if spool.replayed_total != 1 or spool.oldest().path != seg.path:
            raise AssertionError(f"phase E2: the fresh local's spool "
                                 f"replayed {spool.replayed_total}")
        saved = seg.path + ".saved"
        shutil.copyfile(seg.path, saved)
        _restart_import(gserver, address)
        rec["channel_wait_s"] = _await_channel(fresh)
        wait = stamp + PHASE_E_STALE * 3600.0 + 0.5 - time.time()
        if wait > 0:
            time.sleep(wait)
        rec["replay_age_s"] = time.time() - stamp
        imp = gserver.import_server
        fresh.flush()  # no traffic: the pending spool alone dispatches
        rec["replay_flush"] = {k: fresh.last_flush_timings.get(k, 0.0)
                               for k in _LOCAL_TIMING_KEYS}
        stats = fresh.stats_snapshot()
        flow = fresh.forward_client.last_flow
        if (stats["wal_acked"] != PHASE_D_FORWARDED or stats["spool_depth"]
                or flow != {"received": PHASE_D_FORWARDED,
                            "merged": PHASE_D_FORWARDED,
                            "duplicate": False}
                or gserver.backfill.open_intervals != 1
                or imp.imported_total != PHASE_D_FORWARDED):
            raise AssertionError(f"phase E2 replay: {stats}, flow {flow}, "
                                 f"backfill open "
                                 f"{gserver.backfill.open_intervals}")
        rec["backfill_merge_s"] = imp.merge_s["backfill"]
        filed, live = [], []
        for _ in range(2):  # the generation roll, then the idle close
            gserver.flush()
            # flush() joined the sink threads; a flush with nothing to
            # deliver dispatches no sink, so read what arrived
            for m in gserver.metric_sinks[0].drain():
                (filed if m.backfilled else live).append(m)
            rec.setdefault("global_flush", []).append(
                dict(gserver.last_flush_timings))
        rec["backfilled_series"] = len(filed)
        if any(m.name.startswith("smoke.") for m in live):
            raise AssertionError("phase E2: replayed series in the live "
                                 "flush")
        bad_ts = [m for m in filed if m.timestamp != int(stamp)]
        if not filed or bad_ts:
            raise AssertionError(f"phase E2: {len(bad_ts)} of {len(filed)} "
                                 f"backfilled series off the original "
                                 f"interval {int(stamp)}")
        got, buckets = {}, {}
        for m in filed:
            if m.name.endswith(".bucket"):
                le = next(t for t in m.tags if t.startswith("le:"))
                buckets.setdefault(m.name, {})[le] = m.value
            else:
                got[m.name] = m.value
        rec.update(_check_global(
            got, buckets, part[2], part[3], part[4], part[5],
            _set_reference(14, keys["set"], members), members, "phase E2",
            aggregates=True))
        # exactly once: the segment put back after its replay (an ack the
        # crash lost) replays again and is dropped by the token dedupe
        fresh.shutdown()
        started.remove(fresh)
        os.replace(saved, seg.path)
        merged_before = gserver.backfill.merged_total
        again = _phase_e_local(wal_cfg, listen=False)
        again.start()
        started.append(again)
        _await_channel(again)
        again.flush()
        flow = again.forward_client.last_flow
        gserver.flush()
        after = [m for m in gserver.metric_sinks[0].drain()
                 if m.name.startswith("smoke.")]
        if (flow is None or not flow["duplicate"]
                or again.stats_snapshot()["spool_depth"]
                or imp.duplicates_dropped_total != 1
                or gserver.backfill.merged_total != merged_before
                or gserver.backfill.open_intervals or after):
            raise AssertionError(f"phase E2 second replay: flow {flow}, "
                                 f"duplicates {imp.duplicates_dropped_total}"
                                 f", {len(after)} series moved")
        rec["second_replay_flow"] = flow
        rec["launches"] = {k: v - seen[k] for k, v in _read_launches().items()}
        report["intervals"].append(rec)
    finally:
        for server in reversed(started):
            server.shutdown()
        shutil.rmtree(spool_dir, ignore_errors=True)
    report["launches"] = _read_launches()
    report["global"] = gserver.stats_snapshot()
    report["proto_fallback_rows"] = \
        convert.proto_fallback_rows - fallback_before
    if report["proto_fallback_rows"]:
        raise AssertionError(f"phase E: {report['proto_fallback_rows']} rows "
                             f"took the proto fallback encoder")
    for kernel in ("tdigest_flush", "hll_estimate", "llhist_apply"):
        if report["launches"][kernel] <= 0:
            raise AssertionError(f"phase E: {kernel} was not launched")
    return report


# -- phase F: the sink plane at full width ----------------------------------

PHASE_F_LL_KEYS = 5_000


class _Fake:
    """A capturing HTTP endpoint on 127.0.0.1: keeps each request's raw
    body (decoded by the checks, after the flush, so that the sink's
    send time is the transport's) and answers 200."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        outer = self
        self.bodies = []
        self._lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):  # noqa: N802
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with outer._lock:
                    outer.bodies.append(
                        (self.path, self.headers.get("Content-Encoding"),
                         body))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="fake-http", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address
        return f"http://{host}:{port}"

    def take(self) -> list:
        with self._lock:
            out, self.bodies = self.bodies, []
        return out

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)


def _dd_row(s: dict) -> tuple:
    return (s["metric"], s["type"], s["host"], s.get("device"),
            tuple(s["tags"]), s["interval"], s["points"][0][0],
            s["points"][0][1])


def _check_datadog(sink, bodies, metrics) -> dict:
    """The fake's series (each body gunzipped and parsed) against the
    sink's own per-InterMetric rendering `_dd_metric` of the channel
    sink's list, compared as parsed JSON with key order normalised."""
    import gzip

    from veneur_tpu_torch.samplers.metrics import MetricType
    got, raw, plain = [], 0, 0
    for path, encoding, body in bodies:
        if not path.startswith("/api/v1/series") or encoding != "gzip":
            raise AssertionError(f"phase F datadog: unexpected request "
                                 f"{path} ({encoding})")
        raw += len(body)
        body = gzip.decompress(body)
        plain += len(body)
        got.extend(_dd_row(s) for s in json.loads(body)["series"])
    want = [_dd_row(sink._dd_metric(m)) for m in metrics
            if m.type != MetricType.STATUS]
    if sorted(got) != sorted(want):
        raise AssertionError(f"phase F datadog: {len(got)} series posted, "
                             f"{len(want)} expected, or values differ")
    return {"bodies": len(bodies), "body_bytes": raw,
            "json_bytes": plain, "series": len(got)}


def _check_cortex(sink, bodies, metrics) -> dict:
    """The fake's remote-write (snappy-decoded, decode_write_request)
    against the sink's own `_series` of every InterMetric, series by
    series in order, values exact; and the literal-only snappy encode of
    the whole uncompressed write timed on its own."""
    from veneur_tpu_torch.samplers.metrics import MetricType
    from veneur_tpu_torch.sinks.cortex import decode_write_request
    from veneur_tpu_torch.util.http import snappy_decode, snappy_encode
    raw = [body for _path, _enc, body in bodies]
    plain = b"".join(snappy_decode(body) for body in raw)
    t0 = time.perf_counter()
    got = decode_write_request(plain)
    decode_s = time.perf_counter() - t0
    want = [sink._series(m) for m in metrics
            if m.type != MetricType.STATUS]
    if len(got) != len(want) or any(
            sorted(labels.items()) != list(w[0]) or value != w[1]
            or ts != w[2] for (labels, value, ts), w in zip(got, want)):
        raise AssertionError(f"phase F cortex: {len(got)} series posted, "
                             f"{len(want)} expected, or a series differs")
    t0 = time.perf_counter()
    snappy_encode(plain)
    snappy_s = time.perf_counter() - t0
    return {"bodies": len(raw), "body_bytes": sum(map(len, raw)),
            "write_bytes": len(plain), "series": len(got),
            "snappy_encode_s": snappy_s, "decode_s": decode_s}


def _check_prometheus(sink, metrics) -> dict:
    """The exposition scraped over HTTP against `render_exposition` of
    the channel sink's list, byte for byte."""
    from veneur_tpu_torch.sinks.prometheus import render_exposition
    from veneur_tpu_torch.util.http import get
    t0 = time.perf_counter()
    status, body = get(f"http://127.0.0.1:{sink.expose_port}/metrics",
                       timeout=120)
    scrape_s = time.perf_counter() - t0
    want = render_exposition(metrics).encode()
    if status != 200 or body != want:
        raise AssertionError(f"phase F prometheus: scrape {status}, "
                             f"{len(body)} bytes against {len(want)}")
    return {"body_bytes": len(body), "series": body.count(b"\n"),
            "scrape_s": scrape_s}


_F_SINKS = ("channel", "datadog", "cortex", "prometheus")


def _phase_f() -> dict:
    """The sink plane at full width: one server on cuda:0 with the
    channel sink (the reference) and the datadog, cortex and prometheus
    sinks, each datadog and cortex pointed at a capturing fake, phase
    A's corpus plus 5 000 `|l` keys x 32, two intervals (the encoders'
    fragment caches cold, then warm)."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    dd_fake, cx_fake = _Fake(), _Fake()
    corpora = [_corpus(seed, PHASE_A_KEYS, PHASE_F_LL_KEYS) + (
        _set_reference(seed, PHASE_A_KEYS["set"],
                       PHASE_A_KEYS["set_members"]),) for seed in (21, 22)]
    server = _server({"metric_sinks": [
        {"kind": "datadog", "name": "datadog",
         "config": {"datadog_api_key": "smoke",
                    "datadog_api_hostname": dd_fake.url}},
        {"kind": "cortex", "name": "cortex",
         "config": {"url": cx_fake.url + "/api/v1/push"}},
        {"kind": "prometheus", "name": "prometheus",
         "config": {"expose_address": "127.0.0.1:0"}}]},
        {"counter_capacity": 65536, "gauge_capacity": 32768,
         "histo_capacity": 32768, "set_capacity": 16384,
         "llhist_capacity": 8192}, ChannelMetricSink())
    channel, dd, cx, prom = server.metric_sinks
    check = _check_a_or_c(PHASE_A_KEYS)
    _zero_launches()
    server.start()
    try:
        window = _pump_window(server)
        report = {"intervals": [], "window_lines": window}
        base = 0
        seen = _read_launches()
        for corpus in corpora:
            lines = corpus[0]
            ingest_s = _send(server, server.listen_addresses[0], lines,
                             base, window)
            base += len(lines)
            stats = server.stats_snapshot()
            if (stats["lines_received"] != base or stats["lost_lines"]
                    or stats["ingest_dispatch_errors"]):
                raise AssertionError(f"phase F: sent {base} lines: {stats}")
            server.flush()
            now = _read_launches()
            timings = dict(server.last_flush_timings)
            metrics = channel.drain()
            rec = {"lines": len(lines), "ingest_s": ingest_s,
                   "lines_per_s": len(lines) / ingest_s, "flush": timings,
                   "launches": {k: now[k] - seen[k] for k in now},
                   "channel_series": len(metrics)}
            seen = now
            bad = {name: timings[f"sink:{name}"] for name in _F_SINKS
                   if timings[f"sink:{name}"].get("status") != "ok"}
            errors = {k: v for k, v in server.stats_snapshot().items()
                      if k.startswith(("flush.", "resilience.")) and v}
            if bad or errors:
                raise AssertionError(f"phase F: sink records {bad}, "
                                     f"counts {errors}")
            for sink in (dd, cx, prom):
                if sink.last_egress is None \
                        or sink.last_egress[2] != "columnar":
                    raise AssertionError(f"phase F: {sink.name()} took "
                                         f"{sink.last_egress}")
            got, buckets = {}, {}
            for m in metrics:
                if m.name.endswith(".bucket"):
                    le = next(t for t in m.tags if t.startswith("le:"))
                    buckets.setdefault(m.name, {})[le] = m.value
                else:
                    got[m.name] = m.value
            t0 = time.perf_counter()
            rec.update(check(corpus, got, buckets))
            rec["sinks"] = {
                "datadog": _check_datadog(dd, dd_fake.take(), metrics),
                "cortex": _check_cortex(cx, cx_fake.take(), metrics),
                "prometheus": _check_prometheus(prom, metrics)}
            rec["check_s"] = time.perf_counter() - t0
            report["intervals"].append(rec)
    finally:
        server.shutdown()
        dd_fake.close()
        cx_fake.close()
    report["launches"] = _read_launches()
    for kernel in ("tdigest_flush", "hll_estimate", "llhist_apply"):
        if report["launches"][kernel] <= 0:
            raise AssertionError(f"phase F: {kernel} was not launched")
    return report


# -- phase F2: the thread plane ----------------------------------------------

F2_INTERVAL_S = 5.0
# series per F2 interval: 600 counters, 400 timers with min, max, count
# and the percentiles
F2_SERIES = 600 + 400 * (3 + len(PS))


def _f2_sinks():
    """A sink that blocks from its second flush on, and one that raises
    on its first."""
    import threading

    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    class Blocking(ChannelMetricSink):
        def __init__(self):
            super().__init__("blocking")
            self.calls = 0
            self.release = threading.Event()

        def flush_batch(self, batch):
            self.calls += 1
            if self.calls >= 2:
                self.release.wait(timeout=120.0)
            super().flush_batch(batch)

    class FailsOnce(ChannelMetricSink):
        def __init__(self):
            super().__init__("fails_once")
            self.calls = 0

        def flush_batch(self, batch):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("the sink is down")
            super().flush_batch(batch)

    return Blocking(), FailsOnce()


def _f2_lines(interval: int) -> list:
    rng = np.random.default_rng(40 + interval)
    lines = [f"f2.i{interval}.c{k}:{rng.integers(1, 99)}|c"
             for k in range(600)]
    for k in range(400):
        lines += [f"f2.i{interval}.t{k}:{v:.3f}|ms"
                  for v in rng.gamma(2.0, 20.0, 4)]
    return lines


def _phase_f2() -> dict:
    """The thread plane on the card: a server with `interval: 5s` runs
    four intervals on its own flush loop with the datadog sink (to a
    fake), a sink that blocks from its second flush and one that raises
    on its first, `circuit_breaker_failure_threshold: 2`."""
    import gzip

    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.core.server import Server
    fake = _Fake()
    blocking, fails_once = _f2_sinks()
    cfg = config_from_dict({
        "statsd_listen_addresses": ["udp://127.0.0.1:0"],
        "interval": f"{F2_INTERVAL_S:g}s", "hostname": "smoke",
        "percentiles": list(PS), "circuit_breaker_failure_threshold": 2,
        "circuit_breaker_recovery": "1h",
        "metric_sinks": [{"kind": "datadog", "name": "datadog", "config": {
            "datadog_api_key": "smoke",
            "datadog_api_hostname": fake.url}}],
        "tpu": {"counter_capacity": 4096, "histo_capacity": 2048}})
    server = Server(cfg, extra_metric_sinks=[blocking, fails_once])
    _zero_launches()
    report = {"flushes": []}
    sent = 0
    server.start()
    try:
        prev = server.last_flush_timings
        for i in range(4):
            lines = _f2_lines(i)
            _send(server, server.listen_addresses[0], lines, sent,
                  PUMP_WINDOW)
            sent += len(lines)
            deadline = time.monotonic() + 3 * F2_INTERVAL_S
            while server.last_flush_timings is prev:
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase F2: flush {i + 1} did "
                                         f"not happen")
                time.sleep(0.01)
            prev = timings = server.last_flush_timings
            records = {name: dict(timings[f"sink:{name}"]) for name in
                       ("datadog", "blocking", "fails_once")}
            stats = server.stats_snapshot()
            report["flushes"].append({
                "total_s": timings["total_s"], "sinks_s": timings["sinks_s"],
                "records": records,
                "counts": {k: v for k, v in stats.items()
                           if k.startswith(("flush.", "resilience."))}})
            if timings["total_s"] > F2_INTERVAL_S + 0.5:
                raise AssertionError(f"phase F2: flush {i + 1} took "
                                     f"{timings['total_s']:.3f} s")
        report["lines_received"] = server.stats_snapshot()["lines_received"]
        report["breaker"] = server._sink_breakers["metric:blocking"].state
    finally:
        blocking.release.set()
        server.shutdown()
        fake.close()
    report["launches"] = _read_launches()
    flushes = report["flushes"]
    status = [[f["records"][n]["status"] for f in flushes]
              for n in ("datadog", "blocking", "fails_once")]
    counts = flushes[-1]["counts"]
    if status[0] != ["ok"] * 4:
        raise AssertionError(f"phase F2: datadog records {status[0]}")
    if (status[1] != ["ok", "timed_out", "skipped", "skipped"]
            or report["breaker"] != "open"
            or counts["flush.sink_skipped_total#sink:metric:blocking"] != 2
            or counts["resilience.breaker_state#target:metric:blocking"]
            != 1):
        raise AssertionError(f"phase F2: blocking sink {status[1]}, "
                             f"breaker {report['breaker']}, {counts}")
    # the failed first batch arrives with the second as its retry
    received = []
    while not fails_once.queue.empty():
        received.append(sorted({m.name.split(".")[1]
                                for m in fails_once.queue.get_nowait()}))
    if (status[2] != ["error", "ok", "ok", "ok"]
            or received != [["i0", "i1"], ["i2"], ["i3"]]
            or counts["flush.spill_retry_total"] != F2_SERIES
            or counts["flush.spill_shed_total"]):
        raise AssertionError(f"phase F2: failing sink {status[2]}, "
                             f"received {received}, {counts}")
    per_interval = [0] * 4
    for path, encoding, body in fake.take():
        for series in json.loads(gzip.decompress(body))["series"]:
            per_interval[int(series["metric"].split(".")[1][1:])] += 1
    if per_interval != [F2_SERIES] * 4 or report["lines_received"] \
            != sent:
        raise AssertionError(f"phase F2: datadog series per interval "
                             f"{per_interval}, lines {sent} sent, "
                             f"{report['lines_received']} received")
    report["datadog_series_per_interval"] = per_interval
    return report


# -- phase G: the operator surface at full width -------------------------------

PHASE_G_HOST_SETS = 500    # set keys of 4 members: they stay on the host tier
PHASE_G_READERS = 8
PHASE_G_READER_HZ = 10.0
PHASE_G_PIN = {"timer": 48, "llhist": 32, "counter": 48, "gauge": 48,
               "set": 48, "host_set": 32}
# routes phase G must see in the http.route rows
_G_ROUTES = ("/healthcheck", "/healthcheck/ready", "/query", "/alerts",
             "/metrics", "/debug/flush", "/debug/events")


def _g_rules() -> list:
    """64 rules shaped like tests/test_query.py:471-505, eight kinds over
    keys 0-7. Key 0's rule of each kind has a threshold the corpus
    crosses (`for: 0`); the other 56 can never fire."""
    rules = []
    for i in range(8):
        cross = i == 0
        high = 1e12
        rules += [
            {"id": f"c{i}", "metric": f"smoke.c{i}", "kind": "count",
             "op": ">", "threshold": 0.0 if cross else high},
            {"id": f"r{i}", "metric": f"smoke.c{i}", "kind": "rate",
             "op": ">", "threshold": 0.0 if cross else high},
            {"id": f"g{i}", "metric": f"smoke.g{i}", "kind": "value",
             "op": ">", "threshold": -high if cross else high},
            {"id": f"t{i}", "metric": f"smoke.t{i}", "kind": "quantile",
             "q": 0.99, "op": ">", "threshold": 0.0 if cross else high},
            {"id": f"l{i}", "metric": f"smoke.l{i}", "kind": "quantile",
             "q": 0.5, "op": ">", "threshold": 0.0 if cross else high},
            {"id": f"s{i}", "metric": f"smoke.s{i}", "kind": "cardinality",
             "op": ">", "threshold": 16.0 if cross else high},
            {"id": f"b{i}", "metric": f"smoke.l{i}",
             "kind": "bin_occupancy", "lo": 0.0, "hi": 1e7,
             "op": ">=" if cross else ">", "threshold": 0.5 if cross
             else 2.0},
            {"id": f"q{i}", "metric": f"smoke.t{i}", "kind": "quantile",
             "q": 0.5, "op": ">", "threshold": 0.0 if cross else high},
        ]
    for rule in rules:
        rule["for"] = 0
    return rules


def _g_host_sets(seed: int) -> list:
    return [f"smoke.h{k}:u{seed}-{k}-{j}|s"
            for k in range(PHASE_G_HOST_SETS) for j in range(4)]


def _http(address, path: str):
    import urllib.error
    import urllib.request
    host, port = address
    try:
        with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _g_query_paths(rng) -> list:
    """One reader's mix over the kinds, on keys of the corpus."""
    kinds = [
        ("quantile_tdigest", "metric=smoke.t{k}&kind=quantile&q=0.99",
         PHASE_A_KEYS["timer"]),
        ("quantile_llhist", "metric=smoke.l{k}&kind=quantile&q=0.5",
         PHASE_F_LL_KEYS),
        ("count", "metric=smoke.c{k}&kind=count", PHASE_A_KEYS["counter"]),
        ("rate", "metric=smoke.c{k}&kind=rate", PHASE_A_KEYS["counter"]),
        ("value", "metric=smoke.g{k}&kind=value", PHASE_A_KEYS["gauge"]),
        ("cardinality", "metric=smoke.s{k}&kind=cardinality",
         PHASE_A_KEYS["set"]),
        ("bin_occupancy",
         "metric=smoke.l{k}&kind=bin_occupancy&lo=0&hi=1000",
         PHASE_F_LL_KEYS)]
    out = []
    for _ in range(4096):
        kind, query, keys = kinds[int(rng.integers(len(kinds)))]
        out.append((kind, "/query?" + query.format(
            k=int(rng.integers(keys)))))
    return out


class _Readers:
    """PHASE_G_READERS threads, each GETting /query about
    PHASE_G_READER_HZ times a second until stopped. Keeps each query's
    kind, client-side start and seconds, and the captures'
    stale_pending_samples. Whatever ends a reader before it is stopped
    (a status other than 200, a body without the field, a socket error
    or timeout, running out of queries) is booked in `errors`; `finish`
    stops the readers and raises unless every one of them ran until it
    was stopped and every query it sent was answered."""

    def __init__(self, address):
        import threading
        self.address = address
        self.stop = threading.Event()
        self.samples = []  # (kind, start perf_counter, seconds)
        self.stale = []
        self.errors = []
        self.sent = 0
        self.stopped = set()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, args=(i,),
                                          name=f"g-reader-{i}", daemon=True)
                         for i in range(PHASE_G_READERS)]

    def _run(self, i: int) -> None:
        try:
            paths = _g_query_paths(np.random.default_rng(70 + i))
            period = 1.0 / PHASE_G_READER_HZ
            for kind, path in paths:
                if self.stop.is_set():
                    break
                with self._lock:
                    self.sent += 1
                t0 = time.perf_counter()
                status, body = _http(self.address, path)
                elapsed = time.perf_counter() - t0
                if status != 200:
                    raise AssertionError(f"{path} -> {status} {body[:200]}")
                stale = json.loads(body)["stale_pending_samples"]
                with self._lock:
                    self.samples.append((kind, t0, elapsed))
                    self.stale.append(stale)
                self.stop.wait(max(0.0, period - elapsed))
            else:
                raise AssertionError("ran out of queries")
        except BaseException as e:
            with self._lock:
                self.errors.append((i, repr(e)[:300]))
            return
        with self._lock:
            self.stopped.add(i)

    def start(self) -> "_Readers":
        for t in self._threads:
            t.start()
        return self

    def finish(self) -> None:
        self.stop.set()
        for t in self._threads:
            t.join(timeout=120)
            if t.is_alive():
                raise AssertionError(f"phase G: {t.name} did not stop")
        if self.errors or len(self.stopped) != PHASE_G_READERS \
                or len(self.samples) != self.sent:
            raise AssertionError(
                f"phase G: readers failed: {self.errors[:3]}; "
                f"{len(self.stopped)} of {PHASE_G_READERS} ran until "
                f"stopped, {len(self.samples)} of {self.sent} queries "
                f"answered")

    def latency(self, t_from: float = float("-inf"),
                t_to: float = float("inf")) -> dict:
        """Seconds by kind of the queries in flight at some time in
        [t_from, t_to]."""
        out = {}
        for kind, t0, elapsed in self.samples:
            if t0 <= t_to and t0 + elapsed >= t_from:
                out.setdefault(kind, []).append(elapsed)
        return out


def _g_pin_specs():
    """The consistency pin's rows: (flushed series name, spec kwargs)."""
    pin = PHASE_G_PIN
    specs = []
    for k in range(pin["timer"]):
        k = k * (PHASE_A_KEYS["timer"] // pin["timer"])
        for q, label in ((0.5, "50"), (0.99, "99")):
            specs.append((f"smoke.t{k}.{label}percentile",
                          dict(metric=f"smoke.t{k}", kind="quantile", q=q)))
    for k in range(pin["llhist"]):
        k = k * (PHASE_F_LL_KEYS // pin["llhist"])
        for q, label in ((0.5, "50"), (0.99, "99")):
            specs.append((f"smoke.l{k}.{label}percentile",
                          dict(metric=f"smoke.l{k}", kind="quantile", q=q)))
    for family, prefix, kind, keys in (
            ("counter", "smoke.c", "count", PHASE_A_KEYS["counter"]),
            ("gauge", "smoke.g", "value", PHASE_A_KEYS["gauge"]),
            ("set", "smoke.s", "cardinality", PHASE_A_KEYS["set"]),
            ("host_set", "smoke.h", "cardinality", PHASE_G_HOST_SETS)):
        for k in range(pin[family]):
            k = k * (keys // pin[family])
            specs.append((f"{prefix}{k}",
                          dict(metric=f"{prefix}{k}", kind=kind)))
    return specs


def _g_prom_rows(text: str) -> dict:
    """Prometheus text -> {name: [(labels, value)]}; raises on a line
    that is not `# TYPE`/`# HELP` or `name{labels} value`."""
    import re
    sample = re.compile(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)")
    rows = {}
    for line in text.splitlines():
        if line.startswith("# TYPE ") or line.startswith("# HELP "):
            continue
        m = sample.fullmatch(line)
        if m is None:
            raise AssertionError(f"phase G: /metrics line {line!r}")
        labels = dict(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                 m.group(3) or ""))
        rows.setdefault(m.group(1), []).append((labels, float(m.group(4))))
    return rows


class _RoleCount:
    """Stands in for a kernel module's `launches` int: the wrapper's own
    `launches += 1`, where it launches its kernel, calls __iadd__, which
    books the launch to the calling thread's role."""

    def __init__(self, roles: "_LaunchRoles", kernel: str):
        self._roles = roles
        self._kernel = kernel

    def __iadd__(self, n: int) -> "_RoleCount":
        self._roles.book(self._kernel, n)
        return self

    def __int__(self) -> int:
        return sum(r.get(self._kernel, 0)
                   for r in self._roles.counts.values())


class _LaunchRoles:
    """Attributes each kernel launch of the server to the role of the
    thread that made it: `flush` (the smoke's thread inside
    Server.flush()), `alerts` (the alert loop), `ingest` (the pump's
    dispatcher) or `queries` (everything else: the HTTP readers' handler
    threads, and the smoke's own thread outside a flush, the pin). Each
    kernel module's count (`launches`, zeroed) is replaced by a
    _RoleCount, and each thread books its launches into a tally of its
    own: no lock is taken where a kernel launches, and the counts stay
    exactly the wrappers'."""

    def __init__(self):
        import threading
        from veneur_tpu_torch.ops import (hll_estimate, llhist_apply,
                                          tdigest_flush)
        self.in_flush = False
        self._local = threading.local()
        self._tallies = []  # every thread's {role: {kernel: launches}}
        self._tallies_lock = threading.Lock()  # once per thread
        self._mods = (tdigest_flush, hll_estimate, llhist_apply)
        for mod in self._mods:
            mod.launches = _RoleCount(self, mod.__name__.rsplit(".", 1)[1])

    def _role(self) -> str:
        import threading
        thread = threading.current_thread()
        if thread is threading.main_thread():
            return "flush" if self.in_flush else "queries"
        if thread.name == "alert-loop":
            return "alerts"
        if thread.name.startswith("statsd-"):
            return "ingest"
        return "queries"

    def book(self, kernel: str, n: int) -> None:
        tally = getattr(self._local, "tally", None)
        if tally is None:
            tally = self._local.tally = {}
            with self._tallies_lock:
                self._tallies.append(tally)
        role = tally.setdefault(self._role(), {})
        role[kernel] = role.get(kernel, 0) + n

    @property
    def counts(self) -> dict:
        """{role: {kernel: launches}} over every thread's tally."""
        out = {}
        for tally in list(self._tallies):
            for role, kernels in list(tally.items()):
                into = out.setdefault(role, {})
                for kernel, n in list(kernels.items()):
                    into[kernel] = into.get(kernel, 0) + n
        return out

    def restore(self) -> None:
        """Put the plain counts back, at the totals booked."""
        for mod in self._mods:
            mod.launches = int(mod.launches)


def _g_table_bytes(store) -> int:
    """Bytes of the tables' live device tensors."""
    total = 0
    for _family, table in store.tables():
        state = getattr(table, "state", None)
        tensors = (state.values() if isinstance(state, dict)
                   else [state] if state is not None else [])
        total += sum(t.numel() * t.element_size() for t in tensors)
    return total


def _g_quantiles(xs) -> dict:
    xs = np.asarray(xs, np.float64)
    return {"n": int(xs.size), "p50_ms": float(np.quantile(xs, 0.5)) * 1e3,
            "p99_ms": float(np.quantile(xs, 0.99)) * 1e3}


def _phase_g() -> dict:
    """The operator surface at full width: phase F's corpus (plus
    PHASE_G_HOST_SETS four-member sets on the host tier) into one server
    on cuda:0 with the HTTP API, `stats_address` at its own UDP
    listener, the diagnostics loop, the flush watchdog and 64 alert
    rules at 1 s; readiness tripped and restored after flush 1; 8 HTTP
    readers query from interval 2's ingest through its flush; one
    diagnostics round; then the consistency pin, the flush, and the
    surface's checks."""
    from veneur_tpu_torch.core import diagnostics
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    corpora = []
    for seed in (31, 32):
        lines, expect, timers, llhists = _corpus(seed, PHASE_A_KEYS,
                                                 PHASE_F_LL_KEYS)
        corpora.append((lines + _g_host_sets(seed), expect, timers, llhists,
                        _set_reference(seed, PHASE_A_KEYS["set"],
                                       PHASE_A_KEYS["set_members"])))
    server = _server({
        "statsd_listen_addresses": [f"udp://127.0.0.1:{port}"],
        "stats_address": f"127.0.0.1:{port}",
        "http_address": "127.0.0.1:0",
        "features": {"diagnostics_metrics_enabled": True},
        "flush_watchdog_missed_flushes": 3,
        "alerts": {"interval": "1s", "rules": _g_rules()}},
        {"counter_capacity": 65536, "gauge_capacity": 32768,
         "histo_capacity": 32768, "set_capacity": 16384,
         "llhist_capacity": 8192}, ChannelMetricSink())
    check = _check_a_or_c(PHASE_A_KEYS)
    plane, alerts = server.query_plane, server.alerts
    report = {"intervals": []}
    _zero_launches()
    roles = _LaunchRoles()
    server.start()
    readers = None
    try:
        api = server.http_api.address
        if _http(api, "/healthcheck") != (200, b"ok\n"):
            raise AssertionError("phase G: /healthcheck")
        window = _pump_window(server)
        base = self_packets = pin_queries = 0
        for i, corpus in enumerate(corpora):
            lines = corpus[0]
            evals0 = alerts.evals_total
            if i == 1:
                readers = _Readers(api).start()
            ingest_s = _send(server, server.listen_addresses[0], lines,
                             base, window)
            base += len(lines)
            stats = server.stats_snapshot()
            if (stats["lines_received"] != base or stats["lost_lines"]
                    or stats["ingest_dispatch_errors"]):
                raise AssertionError(f"phase G: {base} lines expected: "
                                     f"{stats}")
            rec = {"lines": len(lines), "ingest_s": ingest_s,
                   "lines_per_s": len(lines) / ingest_s}
            if i == 1:
                # one diagnostics round (the loop's period is the 1 h
                # interval): its gauges come out of this flush
                diagnostics.collect(server.statsd,
                                    server.diagnostics.start_time)
                base += server.statsd.packets_sent - self_packets
                self_packets = server.statsd.packets_sent
                _g_wait_received(server, base)
                rec["alert_ticks"] = alerts.evals_total - evals0
                rec["pin"] = _g_pin(server, plane, alerts)
                pin_queries = rec["pin"]["http_queries"]
            t0 = time.perf_counter()
            roles.in_flush = True
            server.flush()
            roles.in_flush = False
            t1 = time.perf_counter()
            rec["flush_wall_s"] = t1 - t0
            rec["flush"] = dict(server.last_flush_timings)
            if i == 1:
                readers.finish()
                rec["query_latency"] = {k: _g_quantiles(v) for k, v in
                                        readers.latency().items()}
                in_flush = [x for v in readers.latency(t0, t1).values()
                            for x in v]
                if not in_flush:
                    raise AssertionError("phase G: no query in flight "
                                         "during the flush")
                rec["query_latency_in_flush"] = _g_quantiles(in_flush)
                rec["reader_queries"] = len(readers.samples)
                rec["reader_stale_pending"] = {
                    "max": int(max(readers.stale)),
                    "mean": float(np.mean(readers.stale))}
                _g_wait_route_count(server, "GET /query",
                                    len(readers.samples) + pin_queries)
            got, buckets = _collect(server.metric_sinks[0])
            rec.update(check(corpus, got, buckets))
            if i == 1:
                rec["pin"]["equal"] = _g_check_pin(rec["pin"].pop("values"),
                                                   got)
                selfm = [name for name in (
                    "flush.total_duration_ns", "flush.metrics_total",
                    "worker.metrics_processed_total",
                    "flush.total_duration.count", "mem.rss_bytes",
                    "device.bytes_in_use") if name in got]
                for name in ("flush.total_duration_ns", "mem.rss_bytes",
                             "device.bytes_in_use"):
                    if name not in selfm:
                        raise AssertionError(f"phase G: {name} missing "
                                             f"from the flush: {selfm}")
                rec["self_metric_series"] = selfm
            # the flush's self-metrics reach the listener before the next
            # interval's lines are counted
            rec["self_packets"] = server.statsd.packets_sent - self_packets
            self_packets = server.statsd.packets_sent
            base += rec["self_packets"]
            _g_wait_received(server, base)
            if i == 0:
                rec["ready"] = _g_readiness(server, api)
            report["intervals"].append(rec)
        report["surface"] = _g_surface(server, api)
    finally:
        if readers is not None:
            readers.stop.set()
        roles.restore()
        server.shutdown()
    report["launches"] = launches = _read_launches()
    report["launches_by_role"] = roles.counts
    for kernel in ("tdigest_flush", "hll_estimate", "llhist_apply"):
        if launches[kernel] <= 0:
            raise AssertionError(f"phase G: {kernel} was not launched")
        if sum(roles.counts.get(role, {}).get(kernel, 0)
               for role in ("queries", "alerts")) <= 0:
            raise AssertionError(f"phase G: the query path launched no "
                                 f"{kernel}: {roles.counts}")
    return report


def _g_wait_received(server, lines: int) -> None:
    deadline = time.monotonic() + 30.0
    while server.stats["lines_received"] < lines:
        if time.monotonic() > deadline:
            raise AssertionError(f"phase G: self-metrics lost: "
                                 f"{server.stats['lines_received']} of "
                                 f"{lines} lines received")
        time.sleep(0.005)


def _g_wait_route_count(server, key: str, want: int) -> None:
    """The route's count (booked just after each answer is written) must
    reach exactly the queries the smoke sent."""
    hist = server.http_api._route_hists[key]
    deadline = time.monotonic() + 10.0
    while hist.snapshot()["count"] < want \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    if hist.snapshot()["count"] != want:
        raise AssertionError(f"phase G: {key} counted "
                             f"{hist.snapshot()['count']}, {want} sent")


def _g_readiness(server, api) -> dict:
    """/healthcheck/ready is 200 after a flush, 503 once the last flush
    is set back past the watchdog's budget, and 200 again when it is
    restored (the watchdog itself next wakes an interval, 1 h, later)."""
    if _http(api, "/healthcheck/ready") != (200, b"ready\n"):
        raise AssertionError("phase G: not ready after a flush")
    last = server.last_flush_unix
    budget = server.config.flush_watchdog_missed_flushes * server.interval
    server.last_flush_unix = last - budget - 60.0
    try:
        status, body = _http(api, "/healthcheck/ready")
    finally:
        server.last_flush_unix = last
    if status != 503 or b"watchdog" not in body:
        raise AssertionError(f"phase G: readiness with the watchdog's "
                             f"budget blown: {status} {body[:200]}")
    if _http(api, "/healthcheck/ready") != (200, b"ready\n"):
        raise AssertionError("phase G: not ready once restored")
    return {"tripped": status, "body": body.decode().strip()}


def _g_pin(server, plane, alerts) -> dict:
    """The consistency pin's queries, with ingest stopped: one capture of
    every family and each pin spec evaluated over it, and a few of them
    again through GET /query. Also reads /alerts after one more tick."""
    from veneur_tpu_torch.core.query import QuerySpec
    specs = [(name, QuerySpec.build(**kw)) for name, kw in _g_pin_specs()]
    ps = plane.ps_for([s for _n, s in specs])
    if ps != PS:
        raise AssertionError(f"phase G: pin percentiles {ps}")
    before = _read_launches()
    t0 = time.perf_counter()
    bundle = plane.capture(("counter", "gauge", "histogram", "llhist", "set"),
                           ps=ps)
    capture_s = time.perf_counter() - t0
    values = {}
    for name, spec in specs:
        res = plane.evaluate(bundle, spec, ps)
        if res["matched_rows"] != 1 or res["value"] is None:
            raise AssertionError(f"phase G: pin query {spec} -> {res}")
        values[name] = res["value"]
    api = server.http_api.address
    http_specs = specs[:: len(specs) // 16]
    for name, spec in http_specs:
        path = f"/query?metric={spec.metric}&kind={spec.kind}"
        if spec.q is not None:
            path += f"&q={spec.q}"
        status, body = _http(api, path)
        if status != 200 or json.loads(body)["value"] != values[name]:
            raise AssertionError(f"phase G: {path} -> {status} {body[:200]}")
    after = _read_launches()
    # the alert states, after one tick that saw the whole interval
    evals = alerts.evals_total
    deadline = time.monotonic() + 30.0
    while alerts.evals_total < evals + 2:
        if time.monotonic() > deadline:
            raise AssertionError("phase G: the alert loop stopped")
        time.sleep(0.05)
    status, body = _http(api, "/alerts")
    rules = json.loads(body)["rules"]
    firing = sorted(r["id"] for r in rules if r["state"] == "firing")
    idle = [r["id"] for r in rules if r["state"] == "idle"]
    if status != 200 or firing != sorted(f"{k}0" for k in "bcglqrst") \
            or len(idle) != 56:
        raise AssertionError(f"phase G: alerts firing {firing}, "
                             f"{len(idle)} idle")
    return {"rows": len(specs), "capture_s": capture_s,
            "stale_pending": {f: bundle[f]["stale_pending"]
                              for f in bundle if f != "as_of_unix"},
            "launches": {k: after[k] - before[k] for k in after},
            "firing": firing, "idle": len(idle), "values": values,
            "http_queries": len(http_specs)}


def _g_check_pin(values: dict, got: dict) -> int:
    """Every pin query == the flushed value of its series, bit for bit."""
    wrong = [(name, v, got.get(name)) for name, v in values.items()
             if got.get(name) != v]
    if wrong:
        raise AssertionError(f"phase G: {len(wrong)} queries differ from "
                             f"the flush, e.g. {wrong[:3]}")
    return len(values)


def _g_surface(server, api) -> dict:
    """/metrics (parsed; the route, device-memory, query and alert rows),
    /debug/flush and /debug/events, and the route and alert figures."""
    status, body = _http(api, "/debug/flush")
    rounds = json.loads(body)["rounds"]
    if status != 200 or [r["flush"] for r in rounds] != [1, 2]:
        raise AssertionError(f"phase G: /debug/flush rounds "
                             f"{[r.get('flush') for r in rounds]}")
    status, body = _http(api, "/debug/events")
    kinds = [e["kind"] for e in json.loads(body)["events"]]
    for kind in ("startup", "flush", "alert_transition"):
        if kind not in kinds:
            raise AssertionError(f"phase G: no {kind} event in {kinds[:8]}")
    _http(api, "/metrics")  # the scrape below then holds its own row
    status, body = _http(api, "/metrics")
    if status != 200:
        raise AssertionError(f"phase G: /metrics {status}")
    rows = _g_prom_rows(body.decode())
    paths = {labels.get("path") for labels, _v in
             rows.get("veneur_http_route_count_total", ())}
    if not set(_G_ROUTES) <= paths:
        raise AssertionError(f"phase G: route rows {sorted(paths)}")
    in_use = [v for labels, v in rows.get("veneur_device_bytes_in_use", ())
              if labels.get("platform") == "gpu"]
    table_bytes = _g_table_bytes(server.store)
    if not in_use or in_use[0] < table_bytes \
            or "veneur_device_bytes_limit" not in rows:
        raise AssertionError(f"phase G: device rows {in_use} against "
                             f"{table_bytes} table bytes")
    for name in ("veneur_query_requests_total", "veneur_query_eval_p99",
                 "veneur_alert_rules", "veneur_alert_firing",
                 "veneur_alert_eval_p99", "veneur_flush_rounds_total",
                 "veneur_ingest_ring_depth"):
        if name not in rows:
            raise AssertionError(f"phase G: /metrics lacks {name}")
    if rows["veneur_alert_rules"][0][1] != 64:
        raise AssertionError("phase G: alert.rules != 64")
    routes = {}
    for key, hist in server.http_api._route_hists.items():
        snap = hist.snapshot()
        routes[key] = {"count": snap["count"], "p50_ms": snap["p50"] * 1e3,
                       "p99_ms": snap["p99"] * 1e3}
    tick = server.alerts._eval_hist.snapshot()
    return {"metric_rows": sum(len(v) for v in rows.values()),
            "device_bytes_in_use": in_use[0], "table_bytes": table_bytes,
            "routes": routes,
            "alert_tick_s": {k: tick[k] for k in ("count", "p50", "p99",
                                                  "max")},
            "events": len(kinds)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "veneur_tpu_torch")):
        print("chip_smoke: veneur_tpu_torch is not beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    from veneur_tpu_torch import native
    from veneur_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, timeout=60, check=True
                         ).stdout.splitlines()[0]
    import google.protobuf
    import grpc
    versions = {"torch": torch.__version__, "cuda": torch.version.cuda,
                "grpc": grpc.__version__,
                "protobuf": google.protobuf.__version__}
    print(f"{gxx}; {versions}", flush=True)
    card = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    _cuda.build_all()
    build_s = time.perf_counter() - t0
    print(f"nvcc built {[src.stem for src in _cuda.sources()]} in "
          f"{build_s:.1f} s", flush=True)
    t0 = time.perf_counter()
    native.load()
    native_build_s = time.perf_counter() - t0
    print(f"g++ built {native.library_path().name} in {native_build_s:.1f} s",
          flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1 = _check_k1(card, 256, gen)
    k1_128 = _check_k1(card, 128, gen)
    k2 = _check_k2(card, gen)
    k3 = _check_k3(card, gen)
    torch.cuda.empty_cache()
    k3_cases = ("uniform", "hot_keys", "pump_chunk", "sender_ordered")
    for label, rec in (("tdigest_flush W=256", k1),
                       ("tdigest_flush W=128", k1_128),
                       ("hll_estimate", k2),
                       *((f"llhist_apply {c}", k3[c]) for c in k3_cases)):
        extra = (f", index_add_ {rec['library_ms']:.5f} ms, one-sample launch "
                 f"{rec['one_sample_launch_ms']:.5f} ms; eager call "
                 f"{rec['eager_ms']:.5f} ms, index_add_ eager "
                 f"{rec['library_eager_ms']:.5f} ms"
                 if "library_ms" in rec else "")
        print(f"{label}: {rec['ms']:.5f} ms (plain {rec['plain_ms']:.3f} "
              f"ms, bound {rec['bound_ms']:.6f} ms by {rec['bound_by']}"
              f"{extra}), max_abs_err {rec['max_abs_err']:.3g}", flush=True)
    route, stress = k3["table_route"], k3["stress"]
    print(f"llhist table route, one {route['samples']}-sample chunk, "
          f"median ms (host ms): " + ", ".join(
              f"{name} {ms:.4f} ({route['host_ms'][name]:.4f})"
              for name, ms in route["ms"].items()) + "; stress "
          f"{stress['calls']} x {stress['samples'] // stress['calls']} "
          f"samples in {stress['launches']} launches, "
          f"{stress['seconds']:.4f} s, equal; launch path us "
          f"{k3['launch_path_us']}", flush=True)

    phases = {}
    for name, run in (("A", _phase_a), ("B", _phase_b), ("C", _phase_c)):
        phases[name] = rep = run()
        torch.cuda.empty_cache()
        for i, rec in enumerate(rep["intervals"]):
            print(f"phase {name} interval {i}: {rec['lines']} lines at "
                  f"{rec['lines_per_s']:.0f} lines/s, flush "
                  f"{rec['flush']['total_s']:.3f} s (llhist bins "
                  f"{rec['flush']['llhist_bins_s']:.3f} s), "
                  f"{rec['series_checked']} series checked, K3 launches "
                  f"{rec['launches']['llhist_apply']}", flush=True)
        print(f"phase {name} launches: {rep['launches']}", flush=True)
    phases["D"] = rep = _phase_d()
    torch.cuda.empty_cache()
    for i, rec in enumerate(rep["intervals"]):
        for j, flush in enumerate(rec["local_flush"]):
            print(f"phase D interval {i} local {j}: {rec['lines'][j]} lines "
                  f"in {rec['ingest_s'][j]:.2f} s, flush "
                  f"{flush['total_s']:.3f} s (dispatch "
                  f"{flush['dispatch_s']:.4f}, device sync "
                  f"{flush['device_sync_s']:.4f}, forward encode "
                  f"{flush['forward_encode_s']:.3f}, forward "
                  f"{flush['forward_s']:.3f})", flush=True)
        g = rec["global_flush"]
        merge = ", ".join(f"{k} {v:.3f}" for k, v in rec["merge_s"].items())
        print(f"phase D interval {i} global: import s over both bodies "
              f"{merge}; V1 body {rec['v1_body_bytes']:.0f} bytes per local; "
            f"flush {g['total_s']:.3f} s (swap {g['swap_s']:.4f}, dispatch "
            f"{g['dispatch_s']:.4f}, device sync {g['device_sync_s']:.4f}, "
            f"assembly {g['assembly_s']:.3f}, sinks {g['sinks_s']:.3f}); "
            f"{rec['series_checked']} series checked; launches "
            f"{rec['launches']}", flush=True)
    print(f"phase D launches: {rep['launches']}", flush=True)
    phases["E"] = rep = _phase_e()
    torch.cuda.empty_cache()
    for rec in rep["intervals"]:
        flush = rec["local_flush"]
        line = (f"phase E {rec['interval']}: {rec['lines']} lines in "
                f"{rec['ingest_s']:.2f} s; local flush " + ", ".join(
                    f"{k} {flush[k]:.4f}" for k in _LOCAL_TIMING_KEYS))
        if "retries" in rec:
            line += f"; retries {rec['retries']}"
        if "segment_bytes" in rec:
            replay = rec["replay_flush"]
            line += (f"; segment {rec['segment_bytes']} bytes; replay "
                     f"{rec['replay_age_s']:.1f} s after the interval "
                     f"began, flush " + ", ".join(
                         f"{k} {replay[k]:.4f}" for k in _LOCAL_TIMING_KEYS)
                     + f"; global backfill merge {rec['backfill_merge_s']:.3f}"
                     f" s, drain s " + ", ".join(
                         f"{g.get('backfill_drain_s', 0.0):.3f}"
                         for g in rec["global_flush"])
                     + f", {rec['backfilled_series']} backfilled series")
        elif "merge_s" in rec:
            g = rec["global_flush"]
            line += ("; global import s " + ", ".join(
                f"{k} {v:.3f}" for k, v in rec["merge_s"].items())
                + f"; global flush {g['total_s']:.3f} s (backfill drain "
                f"{g['backfill_drain_s']:.4f})")
        if "series_checked" in rec:
            line += f"; {rec['series_checked']} series checked"
        if "launches" in rec:
            line += f"; launches {rec['launches']}"
        print(line, flush=True)
    print(f"phase E launches: {rep['launches']} (E1 {rep['e1_launches']})",
          flush=True)
    phases["F"] = rep = _phase_f()
    torch.cuda.empty_cache()
    for i, rec in enumerate(rep["intervals"]):
        flush = rec["flush"]
        print(f"phase F interval {i}: {rec['lines']} lines at "
              f"{rec['lines_per_s']:.0f} lines/s; flush "
              f"{flush['total_s']:.3f} s (assembly {flush['assembly_s']:.3f}"
              f", sinks {flush['sinks_s']:.3f}); " + "; ".join(
                  f"{name} duration {flush['sink:' + name]['duration_s']:.3f}"
                  f" cpu {flush['sink:' + name]['cpu_s']:.3f}"
                  + (f" encode {flush['sink:' + name]['encode_s']:.3f} send "
                     f"{flush['sink:' + name]['send_s']:.3f}"
                     if flush["sink:" + name]["encoder"] else "")
                  for name in _F_SINKS), flush=True)
        sinks = rec["sinks"]
        print(f"phase F interval {i}: channel {rec['channel_series']} "
              f"series; datadog {sinks['datadog']['series']} series in "
              f"{sinks['datadog']['bodies']} bodies, "
              f"{sinks['datadog']['body_bytes']} gzip bytes "
              f"({sinks['datadog']['json_bytes']} JSON); cortex "
              f"{sinks['cortex']['series']} series, "
              f"{sinks['cortex']['body_bytes']} snappy bytes "
              f"({sinks['cortex']['write_bytes']} raw, snappy encode "
              f"{sinks['cortex']['snappy_encode_s']:.3f} s); prometheus "
              f"{sinks['prometheus']['series']} lines, "
              f"{sinks['prometheus']['body_bytes']} bytes; "
              f"{rec['series_checked']} series checked; launches "
              f"{rec['launches']}", flush=True)
    print(f"phase F launches: {rep['launches']}", flush=True)
    phases["F2"] = rep = _phase_f2()
    for i, rec in enumerate(rep["flushes"]):
        print(f"phase F2 flush {i + 1}: total {rec['total_s']:.3f} s, sinks "
              f"{rec['sinks_s']:.3f} s; " + ", ".join(
                  f"{name} {r['status']}" for name, r in
                  rec["records"].items()), flush=True)
    print(f"phase F2: blocking sink's breaker {rep['breaker']}, counts "
          f"{rep['flushes'][-1]['counts']}, datadog series per interval "
          f"{rep['datadog_series_per_interval']}; launches "
          f"{rep['launches']}", flush=True)
    t0 = time.perf_counter()
    phases["G"] = rep = _phase_g()
    rep["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for i, rec in enumerate(rep["intervals"]):
        f_rec = phases["F"]["intervals"][i]
        g_flush, f_flush = rec["flush"], f_rec["flush"]
        print(f"phase G interval {i}: {rec['lines']} lines at "
              f"{rec['lines_per_s']:.0f} lines/s (phase F "
              f"{f_rec['lines_per_s']:.0f}), flush wall "
              f"{rec['flush_wall_s']:.3f} s, total_s "
              f"{g_flush['total_s']:.3f} (phase F, four sinks, "
              f"{f_flush['total_s']:.3f}), before the sinks "
              f"{g_flush['total_s'] - g_flush['sinks_s']:.3f} s (phase F "
              f"{f_flush['total_s'] - f_flush['sinks_s']:.3f}), readout "
              f"lock wait {g_flush.get('readout_lock_wait_s', 0.0):.4f} s; "
              f"{rec['series_checked']} series checked; "
              f"{rec['self_packets']} self-metric packets", flush=True)
    q = rep["intervals"][1]
    pin = q["pin"]
    in_flush = q["query_latency_in_flush"]
    print(f"phase G readers: {q['reader_queries']} queries from interval "
          f"2's ingest through its flush, all answered, client latency by "
          f"kind " + ", ".join(
              f"{k} p50 {v['p50_ms']:.2f} p99 {v['p99_ms']:.2f} ms "
              f"(n {v['n']})" for k, v in sorted(q["query_latency"].items()))
          + f"; in flight during the flush n {in_flush['n']} p50 "
          f"{in_flush['p50_ms']:.2f} p99 {in_flush['p99_ms']:.2f} ms; "
          f"stale_pending {q['reader_stale_pending']}; alert ticks "
          f"{q['alert_ticks']}; readiness with the watchdog tripped "
          f"{rep['intervals'][0]['ready']}", flush=True)
    surface = rep["surface"]
    print(f"phase G pin: {pin['rows']} rows == the flush "
          f"({pin['equal']} equal), one capture {pin['capture_s']:.3f} s, "
          f"stale_pending {pin['stale_pending']}, launches "
          f"{pin['launches']}; alerts firing {pin['firing']}, idle "
          f"{pin['idle']}; alert tick s {surface['alert_tick_s']}; "
          f"self-metric series {q['self_metric_series']}", flush=True)
    print(f"phase G routes (server-side ms): " + ", ".join(
        f"{k} n {v['count']} p50 {v['p50_ms']:.2f} p99 {v['p99_ms']:.2f}"
        for k, v in sorted(surface["routes"].items()))
        + f"; /metrics {surface['metric_rows']} rows, device bytes in use "
        f"{surface['device_bytes_in_use']:.0f} >= tables "
        f"{surface['table_bytes']}", flush=True)
    print(f"phase G launches: {rep['launches']}, by role "
          f"{rep['launches_by_role']}; {rep['seconds']:.1f} s", flush=True)

    def launches(kernel):
        return sum(p["launches"][kernel] for p in phases.values())

    kernels = [
        {"name": "tdigest_flush", "route": "cuda",
         "source": "veneur_tpu_torch/csrc/tdigest_flush.cu",
         "replaces": "veneur_tpu/ops/pallas_tdigest.py:82",
         "launches": launches("tdigest_flush"),
         **{k: k1[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by")},
         "library_ms": None},
        {"name": "hll_estimate", "route": "cuda",
         "source": "veneur_tpu_torch/csrc/hll_estimate.cu",
         "replaces": "veneur_tpu/ops/pallas_hll.py:51",
         "launches": launches("hll_estimate"),
         **{k: k2[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by")},
         "library_ms": None},
        {"name": "llhist_apply", "route": "cuda",
         "source": "veneur_tpu_torch/csrc/llhist_apply.cu",
         "replaces": "veneur_tpu/ops/pallas_llhist.py:55",
         "launches": launches("llhist_apply"),
         **{k: k3["pump_chunk"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "eager_ms", "library_eager_ms")}},
    ]
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln]
             for name, log in _cuda.build_logs.items()}
    print(json.dumps({"details": {
        "card": smi, "gxx": gxx, **versions,
        "build_s": build_s, "native_build_s": native_build_s,
        "ptxas": ptxas, "tdigest_flush": [k1, k1_128], "hll_estimate": k2,
        "llhist_apply": k3, "phases": phases}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
