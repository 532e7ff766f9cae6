#!/usr/bin/env python3
"""Chip smoke test of veneur_tpu_torch: builds the CUDA kernels and the
native parser, holds each kernel against its plain PyTorch version on the
card, then runs the port's server end to end on the card.

    python3 chip_smoke.py [--phases S,J]

`--phases` (or the CHIP_SMOKE_PHASES variable) picks the server phases
to run, by letter (A, B, C, D, E, F, F2, G, H, I, J, S, O, P, M, R, X,
W, U, Z, T, N, Y); with neither, every phase but Y runs. Y needs four cards and runs
only when named:

    python3 chip_smoke.py --phases Y      # on a host with four cards

The kernel checks always run, and the last line is the same either way.

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
     on a tenth of phase A's corpus plus 500 `|l` keys, one interval,
     with the checks of phases A and B;
  7. phase D, the forward tier: two local Servers on the native pump
     forward to one global Server over gRPC (127.0.0.1), all on cuda:0.
     Each local takes phase A's key set and 5 000 `|l` keys x 32 in one
     interval, half of the counter and gauge keys global-only
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
     127.0.0.1 port, all on cuda:0. E1: in interval 1 the global's
     import server is down, the send fails after its retries and the
     carryover holds the interval's 75 000 rows; in interval 2 the
     import server is back at the same address and one send carries
     both intervals merged, and the global's flush is checked against
     the union (counters summed, interval 2's gauges, samples and set
     members of both; an interval delivered with the global up is
     phase D's check). E2: a local with `forward_wal:
     true` appends (fsync'd) an interval while the global is down and
     is shut down; a fresh local on the same spool replays the segment
     to the restarted global (`wal_stale_after_intervals: 0.001` on
     both, 3.6 s), which files it in its backfill plane; two global
     flushes emit every series of it `backfilled`, at the interval's
     original start, checked as above; the segment, put back after its
     replay, replays again and is dropped as a duplicate.
  9. phase F, the sink plane: phase A's corpus plus 5 000 `|l` keys x
     32 into the channel, datadog, cortex and prometheus sinks (the
     datadog and cortex ones at capturing fakes on 127.0.0.1), one
     interval; each fake's series equal to the sink's own rendering;
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
     or ingest;
 12. phase H, the proxy tier: the port's veneur-proxy started through
     its CLI (`python -m veneur_tpu_torch.cmd.veneur_proxy`) as a
     process of its own, with static destinations, probes every 100 ms
     and `ledger_strict`, in front of two globals on fixed 127.0.0.1
     ports, fed by two locals; every server on cuda:0 with
     `ledger_strict`. H1: phase D's width and corpus, one interval; the
     proxy received and routed 2 x 75 000 metrics per interval and sent
     them all (its /metrics), each local's FlowCounts from the proxy
     are whole, every forwarded key flushed on exactly the global the
     port's ConsistentRing names for its ring key, and the two globals'
     union passes phase D's global checks. H2: a tenth of the keys, four
     intervals; global B's import server stops at interval 2 (the
     locals flush at once) and returns on its port at interval 4 (the
     locals flush once the proxy readmitted it); the proxy's events
     hold the ejection and the readmission, sent == merged at the
     globals + the destinations' counted drops + no-destination, every
     interval without drops passes the global checks, interval 3 puts
     every key on A, and from interval 4 B holds exactly the keys it
     held in interval 1; the locals' carryover ends empty. Every closed
     ledger interval of the four servers and the proxy balances.
 13. phase I, the SSF plane (BASELINE config 5): I1 carries phase A's
     key set as SSF samples, four per span and one span per UDP
     datagram (220 000 spans in one interval from 8 sender sockets, every
     fourth an indicator span over 50 services x 20 names, 16
     undecodable datagrams), through the native reader and the C++ SSF
     decoder; every counter, gauge, timer and set series is checked as
     in phase A, the indicator and objective timers' count, min and max
     against the span durations, and each `ssf.names_unique` estimate
     (uniqueness rate 1) against the reference HLL. I2 sends 52 000
     spans an interval (40 000 over UDP, 10 000 framed over `unix://`
     from four trace-client connections, 2 000 over `tcp://`) to four
     span workers and the datadog (a 127.0.0.1 fake), kafka and channel
     span sinks: no span dropped, every span at every sink exactly once,
     the fake's spans equal to the sink's own rendering, the kafka
     records decoding to the spans, their metrics exact. I3 feeds TCP
     (counter and `|l` lines over 4 connections), UNIX datagrams (5 000
     `|l` keys x 32, K3), gRPC `SendPacket` and `SendSpan`, and three
     veneur-emit runs (a UDP counter, an SSF timer, a gRPC metric);
     counters, every llhist `.count` and `.bucket` line and the emitted
     series exact.
 14. phase J, the overload and self-trace planes, each part on cuda:0:
     J1 phase A's corpus plus 5 000 `|l` keys x 32 under
     `ingest_rate_limit_statsd: 100000` with senders paced to 200 000
     lines/s, two intervals: counters and gauges exact, histogram and set
     samples kept + shed == sent, the ledger's admitted + shed == sent,
     every strict ledger interval balanced, no supervisor stall (the
     largest heartbeat age per component is reported). J2 the watermark
     ladder over one server's RSS after start + 16/32 GiB, driven by
     simulated pressure through ok, degraded, shedding and ok with 2 000
     SSF spans an interval: ok intervals checked as phase A with every
     llhist line, degraded keeps 1 in 4 (kept + shed == sent per class,
     every span shed, the llhist lines equal to the registers rebuilt
     from the strided columns K3 applied), shedding flushes no timer,
     set or llhist series and answers 503; three transitions in the
     flight recorder. J3 ingest chaos on the numpy path (drop, truncate
     and duplicate at 0.1, seed 7: the datagrams reaching the parser
     are sent - dropped + duplicated) and the ledger leak drill (the
     imbalance equals the leaked count). J4 phase D's topology at a
     tenth of its keys, local 2 through the proxy's CLI, trace sampling
     at 1: one trace per local across /debug/traces of every tier, the
     self-spans at the channel span sinks, the `|l` exemplars on the
     global's bucket lines once per family. J5 phase A's corpus flushed
     at sample rates 1 and 0: each flush's total_s.

 15. phase S, the pull sources and the table lifecycle, each part on
     cuda:0: S1 OTLP/HTTP at phase A's key widths (40 000 cumulative
     monotonic Sums, 20 000 Gauges, 5 000 cumulative exponential
     histograms at scale 3 with 32 positive buckets, 3 negative ones and
     a zero bucket) in three pushes of 1 000 points a request (every
     tenth JSON, every other gzip), each flushed: push 1 primes the
     counters, every counter is the cumulative delta (a tenth reset in
     push 3), every gauge the value sent, every llhist `.count` and
     `.bucket` line exact against llhist_ref over the smoke's own
     (midpoint, count) pairs, half the histograms downscaled to scale 2
     in push 3 (K3 through the slow path's pending fold). S2 an
     OpenMetrics source scraping a ~46 000-line exposition every second,
     flushed every two scrapes, shut down after eight: each counter's sum
     over the flushes is the last value served minus the first, each
     gauge the last served, the allow/deny-filtered families absent, no
     failed scrape; then veneur-prometheus as a subprocess into a server's
     UDP listener, every packet it reports sent received, its deltas
     exact. S3 key churn on the pump with `idle_key_intervals: 2`,
     `count_unique_timeseries` and a strict ledger: six intervals of
     phase A's key counts (40 000 counters, 20 000 gauges, 30 000 timers,
     10 000 sets, 5 000 `|l` keys; four samples a timer, set and `|l`
     key), half the keys new each interval: every series exact (recycled
     rows included: K1, K2, K3 on recycled rows), the unique count equal
     to the series sent, new keys on recycled rows from interval 5, every
     table's capacity and rows flat over the last three intervals, the
     native intern table within the live rows. S4 `max_rows_per_family:
     2000` under 3 000 counter and 3 000 `|l` keys: 2 000 of each flush
     exactly, the others' samples counted dropped and `agg.rejected`.
 16. phase O, the overlapped flush and the observatories, on cuda:0:
     O1 phase F's corpus (A's keys plus 5 000 `|l` keys x 32) on the
     pump with `flush_async`, the latency observatory and a strict
     ledger: tick 1 swaps interval 1 (the ledger's
     `flush_inflight_snapshot` stock holds its 105 000 rows) and its
     readout runs on the executor while interval 2's lines arrive; tick
     2 delivers interval 1 and the deliver-only pass of shutdown()
     (`flush_on_shutdown: false`) delivers interval 2, each checked as
     phases A and B check theirs; `/debug/latency` gives the dogstatsd
     sample age and each queue's dwell. O2 `cardinality_soft_limit:
     2000`, `cardinality_hard_limit: 10000`, `cardinality_degraded_keep:
     0.1`, `prewarm_ladder` and `llhist_capacity: 4096`: phase A's
     counter and timer keys (one sample each) and 60 000 new `pod:`
     values of `storm.lat` (`|l`) in each of two intervals, interval 2
     re-sending interval 1's admitted pods: each interval admits 2 800
     mints and sheds 7 200 `cardinality_degraded` and 50 000
     `cardinality` exactly (the shed table, the ledger's `ingress.shed`
     and `agg.rejected`), every series exact, the `pod` tag's HLL
     estimate within 3 % of the values its mint attempts carried,
     `storm.lat` first in `/debug/cardinality` and on the exemplar watch
     list; interval 2 doubles the llhist table, and a second server
     without the prewarmer doubles its own with 6 144 `|l` names of one
     key each, so the first apply after the resize is printed with the
     prewarm and without it.
 17. phase P, the device observatory, the profiling plane and the
     SIGUSR2 handoff, on cuda:0. P1: phase D's local corpus (A's keys
     plus 5 000 `|l` keys x 32) on a server with `device_observatory`,
     two intervals, every series checked; after every swap, readout,
     recycle, prewarm rung and resize of every table the HBM ledger's
     total equals the bytes of the tables' live, spare and in-flight
     tensors (walked here) and stays within torch.cuda.memory_allocated;
     one llhist prewarm rung (booked `prewarm` while it runs) and one
     forced doubling of the llhist table inside flush 3's readout, where
     the device watermark rung (soft set between the totals before and
     after the doubling) goes degraded, sheds a tenth of A's timer and
     set samples (kept + shed == sent, from the shed table and the
     ledger) and returns to ok when the recycle releases the old
     generation (`/debug/device`, the `overload_device_*` rows and the
     events show both edges); the kernel registry's launches equal the
     wrappers' counts. P2: `/debug/pprof/profile?seconds=2` during
     interval 2 is a valid pprof with frames of the ingest path, and
     `/debug/profile/device` over interval 2's last twentieth and its
     flush holds K1, K2 and K3 events (each kernel's events and device
     time, the flush window's device busy share, the top five device
     operations) or answers 503 naming why the host gives no device
     events. P3: the port's CLI (`python -m
     veneur_tpu_torch.cmd.veneur`, started before P1) with UDP, the
     HTTP API, `interval: 1s`, flush_on_shutdown and a datadog sink at a
     capturing fake takes counter lines over four sockets at 5 000/s
     through a SIGUSR2 handoff with a TCP connect to its HTTP port every
     20 ms: no connect refused, the ready pid moves to the replacement,
     the old process exits 0, the counters the two processes delivered
     equal the lines they received (each logs its count at shutdown),
     and sent - received stays within 1 %.
 18. phase M, the sharded serving plane (`tpu.shards: 4`), on cuda:0.
     M1: a 4-shard ColumnStore and a single one take the same decoded
     columns in-process, in 65 536-sample chunks (phase A's 40 000
     counter, 20 000 gauge x 2, 30 000 timer x 16 and 10 000 set x 32
     keys and B's 5 000 `|l` keys x 32), two intervals; each flush runs
     table by table as a forwarding local's (t-digest export): counters
     (also against the totals sent), gauges, llhist registers, counts
     and quantiles, HLL registers and set estimates equal bit for bit,
     the llhist sums to 1e-6, the t-digest's count, mass, moments, min,
     max and reciprocal sum within tests/test_sharded_store.py's slack;
     the shards' routed counts sum to the samples sent; the HBM ledger
     equals the tensors after every swap, readout and recycle; each
     family's merge timed in interval 1 (CUDA events), and interval 2's
     flush of both stores alone under torch.profiler for the device's
     busy share and its top device operations. M2: a
     4-shard local Server on the pump at phase D's local width forwards
     to a 4-shard global over gRPC, one interval, checked as phase D
     checks its local and global; the global's `mesh.peer_shards` reads
     4. K1, K2 and K3 must each launch on the sharded apply and flush.
 19. phase R, the elastic reshard (BASELINE.md config 10), on cuda:0,
     every server with `ledger_strict`. R1: two 2-shard servers without
     listeners take M1's decoded columns; the first is resharded 2 -> 3
     halfway through interval 1 (`server.reshard.begin(shards=3,
     block=True)`, WAL in a temporary `reshard_spool_dir`) and holds
     interval 2 on the new plane, the second is the control: every
     flushed series equal to the control's (t-digest percentile rows
     within rtol 1e-6, llhist sums within 1e-12, the rest exact), the
     counters equal to the totals sent, the HBM ledger equal to the
     tensors after the cutover with no `reshard_capture` bytes left, the
     cutover's flush-lock hold split into capture, encode, WAL append,
     decode and merge-back, and the rows moved per family; then a
     cutover whose merge-back is killed after its segments are durable,
     and a fresh 2-shard server on that spool whose recover() replays
     every segment once (a second replays none) and whose flush equals
     the control's. R2: a 2-shard server on the pump at phase A's widths
     with `interval: 5s` on its own flush loop and the HTTP API, fed
     phase A's corpus paced at A's steady rate; after three flushes
     `POST /reshard {"shards": 3}` while the load flows, then two more
     flushes and the last interval at shutdown: every counter's total
     over the flushes equal to what was sent, every strict ledger
     interval balanced, `GET /debug/reshard` idle at epoch 1 with 3
     shards, the `reshard.*` rows on `/metrics`; each flush's seconds
     before, during and after the cutover and its flush-lock hold.
 20. phase X, shards over several cards on one card. X1: a 4-shard
     store in four placement groups on cuda:0 (`shard_groups`: the
     per-group applies, the partial merges and the copies of the
     multi-card path), the 4-shard store of one group and a single store
     take M1's decoded columns, two intervals: every series of the
     grouped store equal to the one-group store's (the t-digest rows
     within rtol 1e-6) and within M1's rules of the single store's, K3
     called once per block and group, the HBM ledger equal to the
     tensors per device, each store's flush seconds and merges timed.
     X2: `parallel.mesh.full_step` with 4 slots on cuda:0 at 100 000
     keys and 8192 samples a slot, held to a single-device oracle as
     the JAX package's dryrun is: counters and HLL registers exact,
     gauges by the last slot that set them, quantiles within the
     dryrun's slack; K1 and K2 on the merged state.
 21. phase W, one round of the SIGKILL reshard soak
     (`veneur_tpu_torch.cmd.reshard_soak`) on cuda:0: a sharded child
     killed with its range segments durable, restarted at the old shard
     count, its replayed flush equal to a never-resharded control's.
 22. phase Y (named only; four cards): Y1, the 4-shard store with each
     shard on its own card against the same store on card 0, M1's
     columns, two intervals: every series equal, K3 launched on each
     card, the HBM ledger equal to the tensors on each card, the flush
     seconds and the bytes the merges copied between cards. Y2: two
     4-shard servers over the cards; the first loses shard 3's card
     halfway through interval 1 (`reshard.device_loss(3)`, 4 -> 3 shards
     over cards 0-2), the second is the control: every series equal,
     the strict ledgers balanced, nothing booked on the lost card.
 23. phase U, the port's native Blaster (sendmmsg, no interpreter lock)
     on the pump: phase A's corpus plus 5 000 `|l` keys x 32, 32 lines a
     datagram; an interning interval sent flow-controlled, then the whole
     corpus sent by the Blaster from its own thread at phase A's steady
     183 640 lines/s while the smoke flushes once a second: every line
     received and applied, every counter's total over the flushes equal
     to what was sent, K1, K2 and K3 launched; then a 5 s unpaced pass:
     datagrams sent and received, `ingest.kernel_drops` (received + drops
     == sent where the host's /proc/net/udp counts drops, which a probe
     of an unread socket decides first; else printed as not counted)
     and lines/s.
 24. phase Z, the crash-replay SIGKILL soak
     (`veneur_tpu_torch.cmd.crash_replay_soak`, two kills) on cuda:0: a
     WAL-on local killed with its interval on disk and its send
     unacknowledged, restarted, replayed; the faulted global's counters
     equal to a control's, its llhist registers bit for bit, the WAL
     drained, every strict ledger balanced; the children's K3 launches.
 25. phase T, the ring-failover soak
     (`veneur_tpu_torch.cmd.ring_failover_soak`) at tests/test_ha.py's
     soak shape on the card host's sockets: every metric accounted for
     through a kill and a restore on the same port, an ejection and a
     readmission.
 26. phase N, the self-contained alert drill
     (`veneur_tpu_torch.cmd.alert_drill`) on cuda:0: a timer's p99 rule
     pending -> firing -> resolved over UDP and HTTP, with its trail in
     `/alerts`, `/debug/events` and `/metrics`; K1 launched by the
     alert rounds' captures.

Phases I, J, S, W, Z, T, N and U run in a side process of their own on
the same card, in that order, started where C stands in the order,
beside the main process's C to X (each of them spends most of its time
on one interpreter lock or waiting on its children, so the two
processes share the host's cores, and with J there both end together).
U's unpaced pass waits until the main process sends no more UDP: it
closes the side's standard input when it reaches X or its end. The side
process prints its phases' reports as one JSON line, which the main
process reports after its own phases, and its failure is the run's. The
last `phase seconds` line gives each phase's seconds and the smoke's
wall time.

Two spawned worker processes build the selected phases' big corpora
(A, B, D, F, G, H1, O1, P1, M, R, X, Y) ahead, in phase order, while
the kernels build and the earlier phases run; a phase takes its corpora
from them, or builds them itself when run alone or in the side process.

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

import functools
import json
import math
import os
import socket
import subprocess
import sys
import threading
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


# corpora main() started building in worker processes, by builder and
# arguments, each a FIFO of futures (two phases may ask for the same one)
_PREBUILT: dict = {}


def _prebuildable(fn):
    """A corpus builder whose result main() may have started building in
    a worker process (_start_prebuild): a call takes the oldest such
    result for its arguments, else builds here."""
    @functools.wraps(fn)
    def build(*args, **kwargs):
        pending = None if kwargs else _PREBUILT.get((fn.__name__,
                                                     repr(args)))
        if pending:
            return pending.pop(0).result()
        return fn(*args, **kwargs)
    return build


@_prebuildable
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


@_prebuildable
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


def _member_hashes(members) -> np.ndarray:
    """hll_ref.hash_member over many members at once (uint64): fnv1a-64
    column by column over the members of each length, then the murmur3
    finalizer, all in wrapping uint64 arithmetic."""
    from veneur_tpu_torch.util import fnv
    out = np.empty(len(members), np.uint64)
    lengths = np.fromiter((len(m) for m in members), np.int64,
                          len(members))
    prime = np.uint64(fnv._FNV64_PRIME)
    for n in np.unique(lengths).tolist():
        at = np.flatnonzero(lengths == n)
        raw = np.frombuffer(b"".join(members[i] for i in at.tolist()),
                            np.uint8).reshape(at.size, n).astype(np.uint64)
        h = np.full(at.size, fnv._FNV64_OFFSET, np.uint64)
        for col in range(n):
            h = (h ^ raw[:, col]) * prime
        out[at] = h
    with np.errstate(over="ignore"):
        for mult in (0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53):
            out ^= out >> np.uint64(33)
            out *= np.uint64(mult)
        out ^= out >> np.uint64(33)
    return out


def _member_regs(members) -> tuple:
    """hll_ref.pos_val(hll_ref.hash_member(m)) over many members at once:
    (register index int64, rho int8)."""
    from veneur_tpu_torch.ops import hll_ref
    h = _member_hashes(members)
    p = np.uint64(hll_ref.P)
    idx = (h >> np.uint64(64 - hll_ref.P)).astype(np.int64)
    w = (h << p) | np.uint64(1 << (hll_ref.P - 1))
    # rho = leading zeros of w + 1, by a binary search over the bits
    lz = np.zeros(w.size, np.int64)
    for shift in (32, 16, 8, 4, 2, 1):
        top = (w >> np.uint64(64 - shift)) == 0
        lz[top] += shift
        w[top] <<= np.uint64(shift)
    return idx, (lz + 1).astype(np.int8)


@_prebuildable
def _set_reference(seed: int, num_keys: int, members: int,
                   more_seeds=(), ids=None) -> np.ndarray:
    """The reference HLL's estimate per key over members u<seed>-<k>-<j>,
    j < members, of `seed` and each of `more_seeds`; k runs over `ids`
    (default range(num_keys)). The registers are built from vectorised
    member hashes, and each key is estimated by hll_ref's own estimator."""
    from veneur_tpu_torch.ops import hll_ref
    keys = list(range(num_keys) if ids is None else ids)
    names = [f"u{s}-{k}-{j}".encode() for k in keys
             for s in (seed, *more_seeds) for j in range(members)]
    idx, rho = _member_regs(names)
    per = members * (1 + len(more_seeds))
    est = np.empty(num_keys)
    regs = np.zeros(hll_ref.M, np.int8)
    for i in range(num_keys):
        sl = slice(i * per, (i + 1) * per)
        regs[:] = 0
        np.maximum.at(regs, idx[sl], rho[sl])
        est[i] = hll_ref.estimate_from_registers(regs)
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
                  percentiles: bool = True, prefix: str = "smoke.t",
                  ids=None) -> int:
    """Timer series of the keys `<prefix><k>` (k over `ids`, default
    0..) against their sorted samples: min/max/count exactly, p50/p99
    within the t-digest's rank slack."""
    n = timers.shape[1]
    t = np.arange(timers.shape[0]) if ids is None else ids
    if aggregates:
        for suffix, want in (("min", timers[:, 0]), ("max", timers[:, -1])):
            vals = np.array([got[f"{prefix}{k}.{suffix}"] for k in t])
            if not np.array_equal(vals, want.astype(np.float64)):
                raise AssertionError(f"timer {suffix} differs")
        counts = np.array([got[f"{prefix}{k}.count"] for k in t])
        if not (counts == n).all():
            raise AssertionError("timer counts differ")
    for p, label in (((0.5, "50"), (0.99, "99")) if percentiles else ()):
        # the t-digest's slack: one k-unit either side of p on the
        # arcsine scale, widened by one sample for the interpolation
        # between neighbouring centroids' midpoints
        lo = np.maximum(np.floor(n * _q_of_k(_k_scale(p) - 1)) - 1, 0)
        hi = np.minimum(np.ceil(n * _q_of_k(_k_scale(p) + 1)), n - 1)
        vals = np.array([got[f"{prefix}{k}.{label}percentile"] for k in t])
        eps = 1e-5 * np.abs(vals) + 1e-4
        below = vals < timers[:, int(lo)] - eps
        above = vals > timers[:, int(hi)] + eps
        if below.any() or above.any():
            raise AssertionError(f"timer p{label} outside its slack for "
                                 f"{int(below.sum() + above.sum())} keys")
    return timers.shape[0] * (3 * aggregates + 2 * percentiles)


def _check_sets(got: dict, set_ref: np.ndarray, members: int,
                slack: int = 1, prefix: str = "smoke.s", ids=None) -> dict:
    est = np.array([got[f"{prefix}{k}"] for k in (
        range(set_ref.shape[0]) if ids is None else ids)])
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
                   vals: np.ndarray, weights: np.ndarray, ids=None,
                   sample_quantile: bool = True) -> int:
    """Every series of the llhist keys `<prefix><k>` (k over `ids`,
    default 0..) against a host
    reference built with llhist_ref from exactly the values sent:
    `.count` and every `.bucket` line exactly, `.sum` against the bins'
    midpoint sum, each percentile against llhist_ref.quantiles and
    (with `sample_quantile`, for keys of many samples) within one bin of
    the sample quantile. Returns series checked."""
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
        name = f"{prefix}{k if ids is None else ids[k]}"
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
            if sample_quantile and not ref.clamped_mask(x):
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
    """A Server on cuda:0 whose span extraction's uniqueness roll is off:
    a server's own flush spans then derive no `ssf.names_unique` sample,
    which would otherwise add a rolled-for set series to the counts the
    phases hold exact (what a local forwards, what a ledger books)."""
    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.core.server import Server
    cfg = config_from_dict({
        "statsd_listen_addresses": ["udp://127.0.0.1:0"],
        "interval": "1h",  # the smoke flushes by hand
        "percentiles": list(PS), "aggregates": ["min", "max", "count"],
        "read_buffer_size_bytes": 8 << 20, "hostname": "smoke",
        **cfg_extra, "tpu": {"batch_cap": 8192, **tpu}})
    server = Server(cfg, extra_metric_sinks=[sink])  # cuda:0
    server.metric_extraction.uniqueness_rate = 0.0
    return server


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
PHASE_C_SEEDS = (5,)  # one interval
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
        for seed in PHASE_C_SEEDS]
    server = _server({}, {"counter_capacity": 8192, "gauge_capacity": 4096,
                          "histo_capacity": 4096, "set_capacity": 2048,
                          "llhist_capacity": 1024,
                          "disable_native_parser": True},
                     ChannelMetricSink())
    return _run_phase("phase C", server, corpora, PY_WINDOW, 1,
                      _check_a_or_c(PHASE_C_KEYS),
                      ("tdigest_flush", "hll_estimate", "llhist_apply"))


PHASE_D_LL_KEYS = 5_000
# one interval: the second, steady-state one was cut for the smoke's
# time limit
PHASE_D_SEEDS = (7,)
# per local and interval: the global-only counter and gauge halves, every
# timer, set and llhist key
PHASE_D_FORWARDED = (PHASE_A_KEYS["counter"] // 2 + PHASE_A_KEYS["gauge"] // 2
                     + PHASE_A_KEYS["timer"] + PHASE_A_KEYS["set"]
                     + PHASE_D_LL_KEYS)


def _phase_d_corpus(seed: int, local: int, keys: dict = PHASE_A_KEYS,
                    ll_keys: int = PHASE_D_LL_KEYS):
    """One local's interval of phase D: phase A's key set (or `keys`),
    half of the counter keys and half of the gauge keys global-only (the
    global-only gauge names carry the local's index, so each is sent by
    one local), set members j in [16 local, 16 local + 32) (the two
    locals overlap by half), and `ll_keys` `|l` keys x 32. Returns the
    lines, the series the local flushes (mixed counters and gauges), the
    global-only counters and gauges, the sorted timer samples and the
    llhist values."""
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
        rng, lines, "smoke.l", ll_keys, 32)
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


@_prebuildable
def _phase_d_interval(seed: int, keys: dict = PHASE_A_KEYS,
                      ll_keys: int = PHASE_D_LL_KEYS):
    """Both locals' corpora of one interval and the global's references:
    counters summed, gauges united, the timers' and llhists' samples
    joined, the set reference over the union's 48 members."""
    parts = [_phase_d_corpus(seed, local, keys, ll_keys)
             for local in (0, 1)]
    global_expect = {}
    for part in parts:
        for name, value in part[2].items():
            global_expect[name] = global_expect.get(name, 0.0) + value \
                if name.startswith("smoke.fc") else value
    timers = np.sort(np.concatenate([p[3] for p in parts], axis=1), axis=1)
    ll_vals = np.concatenate([p[4] for p in parts], axis=1)
    set_ref = _set_reference(seed, keys["set"], 16 + keys["set_members"])
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
    intervals = [_phase_d_interval(seed) for seed in PHASE_D_SEEDS]
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
        if stats["forwarded_total"] != len(PHASE_D_SEEDS) * PHASE_D_FORWARDED:
            raise AssertionError(f"phase D local {i} forwarded "
                                 f"{stats['forwarded_total']}")
    if report["stats"]["global"]["imported_total"] \
            != 2 * len(PHASE_D_SEEDS) * PHASE_D_FORWARDED:
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


def _restart_import(gserver, address: str, phase: str = "phase E") -> None:
    """A fresh import server for `gserver` at the address the stopped one
    held (a gRPC server does not start twice)."""
    from veneur_tpu_torch.forward.server import ImportServer
    gserver.import_server = ImportServer(gserver, address)
    gserver.import_server.start()
    if gserver.import_server.address != address:
        raise AssertionError(f"{phase}: import server rebound to "
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
    on cuda:0; the global's import server is down for the first interval
    and back at the same address for the second, whose one send carries
    both intervals merged by the carryover (phase D checks an interval
    delivered with the global up). E2: a local with `forward_wal: true`
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
        parts = {seed: _phase_d_corpus(seed, 0) for seed in (12, 13)}
        base = 0
        # -- E1: an outage the carryover absorbs ----------------------------
        for i, seed in enumerate((12, 13)):
            part = parts[seed]
            rec = {"interval": f"E1.{i + 1}", "lines": len(part[0])}
            if i == 0:
                gserver.import_server.stop()
            else:
                _restart_import(gserver, address)
            rec["ingest_s"] = _ingest_e(local, part, base)
            base += len(part[0])
            if i == 1:
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
            if i == 0:
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
                    or stats["forward_errors"] != 1):
                raise AssertionError(f"phase E1 interval {i + 1}: flow "
                                     f"{flow}, imported {imp.imported_total}"
                                     f", {stats}")
            if (stats["carryover_merged"] != PHASE_D_FORWARDED
                    or stats["carryover_shed"] or stats["carryover_depth"]):
                raise AssertionError(f"phase E1 recovery: {stats}")
            rec["merge_s"] = {k: imp.merge_s[k] - merge_before[k]
                              for k in imp.merge_s}
            rec["v1_body_bytes"] = imp.v1_bytes
            gserver.flush()
            rec["global_flush"] = dict(gserver.last_flush_timings)
            got, buckets = _collect(gserver.metric_sinks[0])
            # the union of both intervals: counters summed, gauges the
            # second's, samples and set members of both
            old = parts[12]
            expect = dict(part[2])
            for name, value in old[2].items():
                if name.startswith("smoke.fc"):
                    expect[name] += value
            rec.update(_check_global(
                got, buckets, expect,
                np.sort(np.concatenate([old[3], part[3]], axis=1), axis=1),
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
PHASE_F_SEEDS = (21,)  # one interval, as D's (the time limit)


class _Fake:
    """A capturing HTTP endpoint on 127.0.0.1: keeps each request's raw
    body (decoded by the checks, after the flush, so that the sink's
    send time is the transport's) and answers 200."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        outer = self
        self.bodies = []
        # each body's arrival on the perf_counter clock, in step with
        # `bodies` (P3 lays the deliveries out on a timeline)
        self.arrivals = []
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
                    outer.arrivals.append(time.perf_counter())
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            do_PUT = do_POST  # noqa: N815 (the datadog trace intake)

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
            out, self.bodies, self.arrivals = self.bodies, [], []
        return out

    def take_timed(self) -> list:
        """take() with each body's arrival time: [(t, path, encoding,
        body)]."""
        with self._lock:
            out = [(t, *body) for t, body in zip(self.arrivals, self.bodies)]
            self.bodies, self.arrivals = [], []
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
                       PHASE_A_KEYS["set_members"]),) for seed in PHASE_F_SEEDS]
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
    server.metric_extraction.uniqueness_rate = 0.0  # see _server
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


def _http(address, path: str, accept: str = ""):
    import urllib.error
    import urllib.request
    host, port = address
    req = urllib.request.Request(f"http://{host}:{port}{path}",
                                 headers={"Accept": accept} if accept
                                 else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
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


PHASE_H2_KEYS = {k: (v // 10 if k not in ("timer_samples", "set_members")
                     else v) for k, v in PHASE_A_KEYS.items()}
PHASE_H2_LL_KEYS = PHASE_D_LL_KEYS // 10
# B stops at interval 2 and returns at 4, the last
PHASE_H1_SEEDS = (11,)          # one interval
PHASE_H2_INTERVALS = 4
PHASE_H2_FORWARDED = (PHASE_H2_KEYS["counter"] // 2
                      + PHASE_H2_KEYS["gauge"] // 2 + PHASE_H2_KEYS["timer"]
                      + PHASE_H2_KEYS["set"] + PHASE_H2_LL_KEYS)
# the forwarded keys' metric types, by name prefix (the ring key is
# name + type + joined tags, and these carry no tags)
_H_TYPES = (("smoke.fc", "counter"), ("smoke.fg", "gauge"),
            ("smoke.t", "timer"), ("smoke.s", "set"), ("smoke.l", "llhist"))
_H_TIMEOUT_S = 120.0


class _Proxy:
    """The port's veneur-proxy started through its CLI in a process of
    its own (`python -m veneur_tpu_torch.cmd.veneur_proxy -f <yaml>`),
    in front of `destinations`, read through its HTTP API."""

    def __init__(self, destinations, workdir: str, extra=None,
                 phase: str = "phase H"):
        self.grpc_address = f"127.0.0.1:{_free_port()}"
        self.http = ("127.0.0.1", _free_port())
        cfg = {"forward_addresses": list(destinations),
               "grpc_address": self.grpc_address,
               "http_address": "%s:%d" % self.http,
               "discovery_interval": "1s",
               # one interval of a destination's keys fits its queue, so
               # a slow merge never turns into a drop at the door
               "send_buffer_size": 131072,
               "health_check_interval": "100ms",
               "health_check_timeout": "1s",
               "health_unhealthy_after": 3, "health_healthy_after": 2,
               "ledger_strict": True, "ledger_history": 4096,
               **(extra or {})}
        path = os.path.join(workdir, "proxy.yaml")
        with open(path, "w") as f:
            json.dump(cfg, f)  # JSON is YAML
        self.log_path = os.path.join(workdir, "proxy.log")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.cmd.veneur_proxy",
             "-f", path], cwd=ROOT, stdout=self._log,
            stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=ROOT))
        deadline = time.monotonic() + 60.0
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(f"{phase}: the proxy exited "
                                     f"{self.proc.returncode}: {self.tail()}")
            try:
                if _http(self.http, "/healthcheck/ready")[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise AssertionError(f"{phase}: the proxy never became "
                                     f"ready: {self.tail()}")
            time.sleep(0.1)

    def tail(self) -> str:
        self._log.flush()
        with open(self.log_path) as f:
            return f.read()[-3000:]

    def get(self, path: str) -> bytes:
        status, body = _http(self.http, path)
        if status != 200:
            raise AssertionError(f"phase H: proxy {path} answered {status}")
        return body

    def metrics(self) -> dict:
        """{(name, destination or ""): value} of the proxy's /metrics."""
        out = {}
        for name, rows in _g_prom_rows(self.get("/metrics").decode()).items():
            for labels, value in rows:
                key = labels.get("destination") or labels.get("method", "")
                out[(name, key)] = value
        return out

    def events(self, kind: str) -> list:
        return json.loads(self.get(f"/debug/events?kind={kind}"))["events"]

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._log.close()
        return self.proc.returncode


def _h_sum(metrics: dict, name: str) -> float:
    return sum(v for (n, _k), v in metrics.items() if n == name)


def _h_routing(metrics: dict) -> dict:
    """The proxy's routing and destination totals (the per-destination
    rows summed with their retired folds)."""
    out = {k: metrics.get((f"veneur_proxy_{k}_total", ""), 0.0)
           for k in ("received", "routed", "dropped", "no_destination")}
    for k in ("enqueued", "sent", "dropped", "dropped_enqueued"):
        out[f"dest_{k}"] = (_h_sum(metrics, f"veneur_proxy_dest_{k}_total")
                            + metrics.get(
                                (f"veneur_proxy_dest_retired_{k}_total", ""),
                                0.0))
    out["queued"] = _h_sum(metrics, "veneur_proxy_dest_queue_depth")
    return out


def _h_drain(proxy: _Proxy) -> dict:
    """Wait until the proxy's destinations have sent or dropped every
    metric they took; returns the routing totals then."""
    deadline = time.monotonic() + _H_TIMEOUT_S
    while True:
        r = _h_routing(proxy.metrics())
        if (r["dest_enqueued"] == r["dest_sent"] + r["dest_dropped_enqueued"]
                and r["queued"] == 0):
            return r
        if time.monotonic() > deadline:
            raise AssertionError(f"phase H: the proxy's queues never "
                                 f"drained: {r}; {proxy.tail()}")
        time.sleep(0.05)


def _h_base(name: str) -> tuple:
    """A forwarded series' base key and metric type: the key's ring key
    is their concatenation (name + type + joined tags, and no tags)."""
    base = name
    if not (name.startswith(("smoke.fc", "smoke.fg"))
            or (name.startswith("smoke.s") and "." not in name[7:])):
        base = name.rsplit(".", 1)[0]
    return base, next(t for prefix, t in _H_TYPES if base.startswith(prefix))


def _h_union(gservers, addresses, ring) -> tuple:
    """Both globals' flushed series united (a series on both is an
    error), with each base key's placement: {address: set of base keys};
    and the base keys on a global other than the ring's choice."""
    got, buckets, placed, misplaced = {}, {}, {}, []
    for gserver, address in zip(gservers, addresses):
        # drained, not awaited: a global that received nothing this
        # interval delivers nothing (flush() joined its sink threads)
        g_got, g_buckets = {}, {}
        for m in gserver.metric_sinks[0].drain():
            if m.name.endswith(".bucket"):
                le = next(t for t in m.tags if t.startswith("le:"))
                g_buckets.setdefault(m.name, {})[le] = m.value
            else:
                g_got[m.name] = m.value
        both = set(g_got) & set(got)
        if both:
            raise AssertionError(f"phase H: series on both globals, e.g. "
                                 f"{sorted(both)[:3]}")
        got.update(g_got)
        buckets.update(g_buckets)
        keys = placed.setdefault(address, set())
        for name in list(g_got) + list(g_buckets):
            base, mtype = _h_base(name)
            keys.add(base)
            if ring is not None and ring.get(base + mtype) != address:
                misplaced.append((base, address, ring.get(base + mtype)))
    return got, buckets, placed, misplaced


def _h_ledgers(servers, proxy: _Proxy, phase: str) -> dict:
    """Every closed ledger interval of the four servers and the proxy
    balanced (the servers run ledger_strict, so a flush would have
    raised; the proxy's strict close only logs)."""
    out = {}
    for name, server in servers.items():
        bad = [imb for imb in server.ledger.history_imbalances()
               if any(imb.values())]
        if bad:
            raise AssertionError(f"{phase}: {name} ledger imbalance {bad[:3]}")
        out[name] = server.ledger.intervals_closed
    report = json.loads(proxy.get("/debug/ledger"))
    unexplained = {k: v["unexplained_total"]
                   for k, v in report["identities"].items()}
    if any(unexplained.values()):
        raise AssertionError(f"{phase}: proxy ledger unexplained "
                             f"{unexplained}")
    out["proxy"] = report["intervals_closed"]
    if not out["proxy"]:
        raise AssertionError(f"{phase}: the proxy closed no ledger interval")
    return out


def _h_servers(imp_ports):
    """Two globals on fixed 127.0.0.1 ports; both on cuda:0."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    return [_server({"grpc_address": f"127.0.0.1:{port}",
                     "statsd_listen_addresses": [], "ledger_strict": True},
                    {"counter_capacity": 32768, "gauge_capacity": 32768,
                     "histo_capacity": 32768, "set_capacity": 16384,
                     "llhist_capacity": 8192}, ChannelMetricSink())
            for port in imp_ports]


def _h_locals(address: str):
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    return [_server({"forward_address": address, "ledger_strict": True},
                    {"counter_capacity": 65536, "gauge_capacity": 32768,
                     "histo_capacity": 32768, "set_capacity": 16384,
                     "llhist_capacity": 8192}, ChannelMetricSink())
            for _ in range(2)]


def _h_interval(locals_, gservers, proxy, parts, bases, windows,
                forwarded: int, phase: str, before_flush=None) -> dict:
    """One interval through the tier: ingest on both locals, run
    `before_flush`, flush the locals (their forward goes through the
    proxy), wait for the proxy's queues, flush both globals. Returns the
    timings and the proxy's deltas."""
    rec = {"ingest_s": [], "local_flush": [], "lines": []}
    for i, (server, part) in enumerate(zip(locals_, parts)):
        rec["ingest_s"].append(_send(server, server.listen_addresses[0],
                                     part[0], bases[i], windows[i]))
        bases[i] += len(part[0])
        rec["lines"].append(len(part[0]))
        stats = server.stats_snapshot()
        if (stats["lines_received"] != bases[i] or stats["lost_lines"]
                or stats["ingest_dispatch_errors"]):
            raise AssertionError(f"{phase} local {i}: {stats}")
    before = proxy.metrics()
    merge_before = [dict(g.import_server.merge_s) for g in gservers]
    imported_before = [g.stats_snapshot()["imported_total"]
                       for g in gservers]
    if before_flush is not None:
        before_flush()
    for i, server in enumerate(locals_):
        server.flush()
        rec["local_flush"].append(dict(server.last_flush_timings))
        stats = server.stats_snapshot()
        flow = server.forward_client.last_flow
        if stats["forward_errors"] or flow != {
                "received": forwarded, "merged": forwarded,
                "duplicate": False}:
            raise AssertionError(f"{phase} local {i}: FlowCounts {flow}, "
                                 f"{stats}")
    t0 = time.perf_counter()
    _h_drain(proxy)
    rec["proxy_drain_s"] = time.perf_counter() - t0
    after = proxy.metrics()
    b, a = _h_routing(before), _h_routing(after)
    rec["proxy"] = {k: a[k] - b[k] for k in a if k != "queued"}
    rec["proxy_rpc_s"] = {
        k[1]: v - before.get(k, 0.0) for k, v in after.items()
        if k[0] == "veneur_rpc_seconds_total"}
    rec["dest_send_s"] = {
        k[1]: v - before.get(k, 0.0) for k, v in after.items()
        if k[0] == "veneur_proxy_dest_send_seconds_total"}
    rec["global_flush"], rec["merge_s"], rec["imported"] = [], [], []
    for g, mb, ib in zip(gservers, merge_before, imported_before):
        imp = g.import_server
        rec["merge_s"].append({k: imp.merge_s.get(k, 0.0) - mb.get(k, 0.0)
                               for k in imp.merge_s})
        rec["imported"].append(g.stats_snapshot()["imported_total"] - ib)
        g.flush()
        rec["global_flush"].append(dict(g.last_flush_timings))
    return rec


def _phase_h1(workdir: str) -> dict:
    """Two locals -> the proxy (a process of its own, started through its
    CLI) -> two globals, at phase D's width, one interval."""
    from veneur_tpu_torch.proxy.ring import ConsistentRing
    ports = [_free_port(), _free_port()]
    addresses = [f"127.0.0.1:{p}" for p in ports]
    ring = ConsistentRing()
    ring.set_members(addresses)
    intervals = [_phase_d_interval(seed) for seed in PHASE_H1_SEEDS]
    gservers = _h_servers(ports)
    locals_, proxy = [], None
    report = {"intervals": []}
    _zero_launches()
    try:
        for g in gservers:
            g.start()
        proxy = _Proxy(addresses, workdir)
        locals_ = _h_locals(proxy.grpc_address)
        for server in locals_:
            server.start()
        windows = [_pump_window(server) for server in locals_]
        bases = [0, 0]
        for parts, (g_expect, timers, ll_vals, ll_w, set_ref) in intervals:
            rec = _h_interval(locals_, gservers, proxy, parts, bases,
                              windows, PHASE_D_FORWARDED, "phase H1")
            p = rec["proxy"]
            want = 2 * PHASE_D_FORWARDED
            if not (p["received"] == p["routed"] == want == p["dest_sent"]
                    and p["dropped"] == p["no_destination"] == 0
                    and p["dest_dropped"] == 0):
                raise AssertionError(f"phase H1: proxy routing {p}")
            if sum(rec["imported"]) != want:
                raise AssertionError(f"phase H1: the globals imported "
                                     f"{rec['imported']}")
            checked = sum(_check_local(server, part, f"phase H1 local {i}")
                          for i, (server, part)
                          in enumerate(zip(locals_, parts)))
            got, buckets, placed, misplaced = _h_union(gservers, addresses,
                                                       ring)
            if misplaced:
                raise AssertionError(f"phase H1: {len(misplaced)} keys off "
                                     f"their ring owner, e.g. "
                                     f"{misplaced[:3]}")
            rec.update(_check_global(got, buckets, g_expect, timers, ll_vals,
                                     ll_w, set_ref,
                                     16 + PHASE_A_KEYS["set_members"],
                                     "phase H1"))
            rec["series_checked"] += checked
            rec["keys_per_global"] = [len(placed.get(a, ())) for a in
                                      addresses]
            report["intervals"].append(rec)
        report["ledger_intervals"] = _h_ledgers(
            {"local 0": locals_[0], "local 1": locals_[1],
             "global A": gservers[0], "global B": gservers[1]}, proxy,
            "phase H1")
    finally:
        for server in locals_:
            server.shutdown()
        if proxy is not None:
            report["proxy_exit"] = proxy.stop()
        for g in gservers:
            g.shutdown()
    report["launches"] = _read_launches()
    for kernel in ("tdigest_flush", "hll_estimate", "llhist_apply"):
        if report["launches"][kernel] <= 0:
            raise AssertionError(f"phase H1: {kernel} was not launched")
    return report


def _h_wait_event(proxy: _Proxy, kind: str, address: str) -> float:
    t0 = time.perf_counter()
    deadline = time.monotonic() + 60.0
    while not any(e.get("destination") == address
                  for e in proxy.events(kind)):
        if time.monotonic() > deadline:
            raise AssertionError(f"phase H2: no {kind} of {address}: "
                                 f"{proxy.tail()}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _phase_h2(workdir: str) -> dict:
    """Kill and restore global B behind the proxy at a tenth of phase D's
    keys, four intervals: B's import server stops at interval 2, after
    the ingest and just before the locals flush (so the proxy routes to
    B until it ejects it, and what it took for B in that window is
    dropped and must be counted), and returns on the same port at
    interval 4 (the locals flush once the proxy has readmitted it)."""
    from veneur_tpu_torch.proxy.ring import ConsistentRing
    ports = [_free_port(), _free_port()]
    addresses = [f"127.0.0.1:{p}" for p in ports]
    ring = ConsistentRing()
    ring.set_members(addresses)
    keys = PHASE_H2_KEYS
    intervals = [_phase_d_interval(seed, keys, PHASE_H2_LL_KEYS)
                 for seed in range(21, 21 + PHASE_H2_INTERVALS)]
    gservers = _h_servers(ports)
    locals_, proxy = [], None
    report = {"intervals": []}
    b_keys = None
    sent = merged = dropped = no_dest = 0
    try:
        for g in gservers:
            g.start()
        proxy = _Proxy(addresses, workdir)
        locals_ = _h_locals(proxy.grpc_address)
        for server in locals_:
            server.start()
        windows = [_pump_window(server) for server in locals_]
        bases = [0, 0]
        for n, (parts, (g_expect, timers, ll_vals, ll_w, set_ref)) in \
                enumerate(intervals, 1):
            event_s = None
            if n == 4:
                _restart_import(gservers[1], addresses[1], "phase H2")
                event_s = _h_wait_event(proxy, "ring_readmission",
                                        addresses[1])
            rec = _h_interval(
                locals_, gservers, proxy, parts, bases, windows,
                PHASE_H2_FORWARDED, "phase H2",
                before_flush=((lambda: gservers[1].import_server.stop(0))
                              if n == 2 else None))
            rec["interval"] = n
            if n == 2:
                event_s = _h_wait_event(proxy, "ring_ejection", addresses[1])
            rec["event_wait_s"] = event_s
            p = rec["proxy"]
            sent += p["received"]
            merged += sum(rec["imported"])
            dropped += p["dest_dropped"]
            no_dest += p["no_destination"]
            for i, (server, part) in enumerate(zip(locals_, parts)):
                _check_local(server, part, f"phase H2 local {i}")
            # interval 3 runs with B ejected: every key on A
            members = addresses if n != 3 else addresses[:1]
            iv_ring = ConsistentRing()
            iv_ring.set_members(members)
            got, buckets, placed, misplaced = _h_union(
                gservers, addresses, None if n == 2 else iv_ring)
            rec["keys_per_global"] = [len(placed.get(a, ())) for a in
                                      addresses]
            if n == 2 and (p["dest_dropped"] or p["no_destination"]):
                # the detection window dropped what the proxy took for B
                # before its breaker and the ejection: counted, so the
                # accounting below holds it; the values cannot be whole
                report["intervals"].append(rec)
                continue
            if misplaced or p["dest_dropped"] or p["no_destination"]:
                raise AssertionError(
                    f"phase H2 interval {n}: {len(misplaced)} keys off "
                    f"their ring owner ({misplaced[:3]}), routing {p}")
            rec.update(_check_global(got, buckets, g_expect, timers,
                                     ll_vals, ll_w, set_ref,
                                     16 + keys["set_members"],
                                     f"phase H2 interval {n}"))
            if n == 1:
                b_keys = placed[addresses[1]]
            elif n >= 4 and placed.get(addresses[1]) != b_keys:
                raise AssertionError(
                    f"phase H2 interval {n}: B holds "
                    f"{len(placed.get(addresses[1], ()))} keys, "
                    f"{len(b_keys)} in interval 1")
            report["intervals"].append(rec)
        report["ledger_intervals"] = _h_ledgers(
            {"local 0": locals_[0], "local 1": locals_[1],
             "global A": gservers[0], "global B": gservers[1]}, proxy,
            "phase H2")
        for i, server in enumerate(locals_):
            depth = server.stats_snapshot()["carryover_depth"]
            if depth:
                raise AssertionError(f"phase H2 local {i}: carryover "
                                     f"depth {depth}")
        report["events"] = {k: len(proxy.events(k)) for k in
                            ("ring_ejection", "ring_readmission")}
    finally:
        for server in locals_:
            server.shutdown()
        if proxy is not None:
            report["proxy_exit"] = proxy.stop()
        for g in gservers:
            g.shutdown()
    report["accounting"] = {
        "sent": sent, "merged": merged, "dest_dropped": dropped,
        "no_destination": no_dest,
        "loss_unaccounted": sent - merged - dropped - no_dest}
    if report["accounting"]["loss_unaccounted"] or \
            sent != PHASE_H2_INTERVALS * 2 * PHASE_H2_FORWARDED:
        raise AssertionError(f"phase H2: accounting "
                             f"{report['accounting']}")
    report["launches"] = _read_launches()
    return report


def _phase_h() -> dict:
    """Phase H: the proxy tier (H1 at full width, then H2's kill and
    restore). The launch counts are zeroed before H1 and read after H2."""
    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix="smoke-h-")
    try:
        h1 = _phase_h1(workdir)
        torch.cuda.empty_cache()
        h2 = _phase_h2(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"H1": h1, "H2": h2, "launches": h2["launches"]}



# -- phase I: the SSF plane and the other ingest listeners -------------------

PHASE_I_KEYS = PHASE_A_KEYS
PHASE_I_SERVICES = 50
PHASE_I_NAMES = 20
PHASE_I_BAD = 16                 # undecodable datagrams per interval
PHASE_I1_SEEDS = (11,)           # one interval
PHASE_I_SENDERS = 8
PHASE_I2_SPANS = {"udp": 40_000, "unix": 10_000, "tcp": 2_000}
PHASE_I2_STREAMS = 4             # unix:// connections of trace.StreamBackend
PHASE_I2_KEYS = {"counter": PHASE_I_KEYS["counter"] // 10,
                 "timer": PHASE_I_KEYS["timer"] // 10}
PHASE_I3 = {"tcp_counter_keys": 2_000, "tcp_counter_lines": 10_000,
            "tcp_ll_keys": 500, "tcp_ll_samples": 20, "tcp_conns": 4,
            "unix_ll_keys": 5_000, "unix_ll_samples": 32,
            "grpc_packets": 1_000, "grpc_lines": 50, "grpc_keys": 5_000,
            "grpc_spans": 1_000, "grpc_span_keys": 100}
_I_T0 = 1_700_000_000_000_000_000  # span start timestamps (ns)
_I_DGRAM_OVERHEAD = 800  # kernel bytes per queued datagram beyond its data


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _pb_bytes(field: int, data: bytes) -> bytes:
    return _pb_varint(field << 3 | 2) + _pb_varint(len(data)) + data


def _ssf_sample(head: bytes, value: float = 0.0, rate: float = 1.0,
                member: bytes = b"") -> bytes:
    """An SSFSample's wire bytes: `head` holds its metric enum and name,
    then the float32 value (field 3), a set member (field 5) and a sample
    rate (field 7) other than 1."""
    import struct
    out = head + b"\x1d" + struct.pack("<f", value)
    if member:
        out += _pb_bytes(5, member)
    if rate != 1.0:
        out += b"\x3d" + struct.pack("<f", rate)
    return out


def _ssf_head(metric: int, name: str) -> bytes:
    return (b"\x08" + _pb_varint(metric) if metric else b"") + _pb_bytes(
        2, name.encode())


def _ssf_span(span_id: int, start: int, duration: int, service: bytes,
              name: bytes, samples, indicator: bool = False) -> bytes:
    """An SSFSpan's wire bytes (a root span: trace id = id)."""
    out = [b"\x10", _pb_varint(span_id), b"\x18", _pb_varint(span_id),
           b"\x28", _pb_varint(start), b"\x30",
           _pb_varint(start + duration), _pb_bytes(8, service)]
    out.extend(_pb_bytes(10, s) for s in samples)
    if indicator:
        out.append(b"\x60\x01")
    out.append(_pb_bytes(13, name))
    return b"".join(out)


@_prebuildable
def _i1_corpus(seed: int) -> dict:
    """One interval of phase I1: phase A's key set carried as SSF samples,
    four per span and one span per datagram (a gauge key's two samples
    ride one span, the later one wins), every fourth span an indicator
    span over 50 services x 20 names, the span order shuffled, and 16
    undecodable datagrams."""
    keys = PHASE_I_KEYS
    rng = np.random.default_rng(seed)
    c_head = [_ssf_head(0, f"smoke.c{k}") for k in range(keys["counter"])]
    cvals = rng.integers(1, 1000, keys["counter"]).astype(np.float32)
    crates = np.where(np.arange(keys["counter"]) % 4 == 0, 0.5, 1.0)
    expect = {f"smoke.c{k}": float(math.trunc(float(cvals[k]) / crates[k]))
              for k in range(keys["counter"])}
    units = [_ssf_sample(c_head[k], float(cvals[k]), float(crates[k]))
             for k in range(keys["counter"])]
    gvals = rng.normal(0, 100, (keys["gauge"], 2)).astype(np.float32)
    for k in range(keys["gauge"]):
        expect[f"smoke.g{k}"] = float(gvals[k, 1])
    tvals = rng.gamma(2.0, 25.0, (keys["timer"], keys["timer_samples"])
                      ).astype(np.float32)
    for k in range(keys["timer"]):
        head = _ssf_head(2, f"smoke.t{k}")
        units.extend(_ssf_sample(head, float(v)) for v in tvals[k])
    for k in range(keys["set"]):
        head = _ssf_head(3, f"smoke.s{k}")
        units.extend(_ssf_sample(head, member=f"u{seed}-{k}-{j}".encode())
                     for j in range(keys["set_members"]))
    order = rng.permutation(len(units))
    groups = [[units[i] for i in order[j:j + 4]]
              for j in range(0, len(order), 4)]
    for k in range(0, keys["gauge"], 2):
        groups.append([_ssf_sample(_ssf_head(1, f"smoke.g{kk}"),
                                   float(gvals[kk, j]))
                       for kk in (k, k + 1) for j in (0, 1)])
    groups = [groups[i] for i in rng.permutation(len(groups))]
    durations = rng.integers(1_000, 1 << 24, len(groups))
    dgrams = []
    ind_durs: dict = {}
    names_seen: dict = {}
    for i, samples in enumerate(groups):
        service = i // 4 % PHASE_I_SERVICES
        name = i // (4 * PHASE_I_SERVICES) % PHASE_I_NAMES
        indicator = i % 4 == 0
        dgrams.append(_ssf_span(seed * 10_000_000 + i + 1, _I_T0 + i * 1000,
                                int(durations[i]), b"svc%d" % service,
                                b"n%d" % name, samples, indicator))
        names_seen.setdefault((service, indicator), set()).add(name)
        if indicator:
            ind_durs.setdefault((service, name), []).append(durations[i])
    for j in range(PHASE_I_BAD):
        dgrams.insert(int(rng.integers(len(dgrams))), b"\x07bad\xff%d" % j)
    timers = np.sort(tvals, axis=1)
    return {"dgrams": dgrams, "expect": expect, "timers": timers,
            "set_ref": _set_reference(seed, keys["set"],
                                      keys["set_members"]),
            "ind_durs": ind_durs, "names_seen": names_seen,
            "samples": sum(len(g) for g in groups)}


def _i_server(cfg_extra: dict, tpu: dict, span_sinks=()):
    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    cfg = config_from_dict({
        "interval": "1h", "percentiles": list(PS),
        "aggregates": ["min", "max", "count"], "hostname": "smoke",
        "read_buffer_size_bytes": 32 << 20,
        **cfg_extra, "tpu": {"batch_cap": 8192, **tpu}})
    import random
    server = Server(cfg, extra_metric_sinks=[ChannelMetricSink()],
                    extra_span_sinks=list(span_sinks),
                    rng=random.Random(0))  # cuda:0
    server.metric_extraction.uniqueness_rate = 0.0  # see _server
    return server


def _collect_tagged(sink) -> tuple:
    """The flushed series by (name, tags), and by name for the untagged
    ones with the `.bucket` lines by name and `le:` tag."""
    tagged, got, buckets = {}, {}, {}
    for m in sink.wait_flush(timeout=600):
        if m.name.endswith(".bucket"):
            le = next(t for t in m.tags if t.startswith("le:"))
            buckets.setdefault(m.name, {})[le] = m.value
        elif m.tags:
            tagged[(m.name, tuple(m.tags))] = m.value
        else:
            got[m.name] = m.value
    return tagged, got, buckets


def _send_ssf(server, addr, dgrams, base: int, window: int,
              senders: int) -> float:
    """Send SSF datagrams round-robin over `senders` sockets, paced by
    the server's received-packet count; returns when every one has been
    received (or raises)."""
    def received():
        return server.stats["ssf_packets_received"]
    sent = base
    t0 = time.perf_counter()
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(senders)]
    try:
        for i, dgram in enumerate(dgrams):
            if sent - base >= window and i % 64 == 0:
                deadline = time.monotonic() + 30.0
                while sent - received() > window:
                    if time.monotonic() > deadline:
                        raise AssertionError("server stopped receiving SSF")
                    time.sleep(0.0005)
            socks[i % senders].sendto(dgram, addr)
            sent += 1
    finally:
        for s in socks:
            s.close()
    deadline = time.monotonic() + 120.0
    while received() < sent:
        if time.monotonic() > deadline:
            raise AssertionError(f"SSF datagrams lost on loopback: sent "
                                 f"{sent}, received {received()}")
        time.sleep(0.001)
    return time.perf_counter() - t0


def _i_window(listener, dgrams) -> tuple:
    rcvbuf = sum(s.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
                 for s in listener._socks)
    per = sum(len(d) for d in dgrams[:1000]) / 1000 + _I_DGRAM_OVERHEAD
    return rcvbuf, max(256, int(rcvbuf // (2 * per)))


def _check_i1(corpus, tagged, got) -> int:
    """Every series of I1: the counters, gauges, timers and sets of phase
    A's checks, the indicator (per service) and objective (per service
    and name) timers' count, min and max, and each ssf.names_unique
    estimate against the reference HLL over the names sent."""
    from veneur_tpu_torch.ops import hll_ref
    _check_exact(got, corpus["expect"])
    checked = len(corpus["expect"]) + _check_timers(got, corpus["timers"])
    _check_sets(got, corpus["set_ref"], PHASE_I_KEYS["set_members"])
    checked += PHASE_I_KEYS["set"]
    per_service: dict = {}
    for (service, name), durs in corpus["ind_durs"].items():
        per_service.setdefault(service, []).extend(durs)
    series = [("sli.t", (f"error:false", f"service:svc{s}"), d)
              for s, d in per_service.items()]
    series += [("slo.t", ("error:false", f"objective:n{n}",
                          f"service:svc{s}"), d)
               for (s, n), d in corpus["ind_durs"].items()]
    bad = []
    for name, tags, durs in series:
        want = (float(len(durs)), float(min(durs)), float(max(durs)))
        have = tuple(tagged.get((f"{name}.{agg}", tags))
                     for agg in ("count", "min", "max"))
        if have != want:
            bad.append((name, tags, have, want))
    if len(per_service) != PHASE_I_SERVICES or len(series) != \
            PHASE_I_SERVICES + PHASE_I_SERVICES * PHASE_I_NAMES:
        raise AssertionError(f"phase I1: {len(series)} indicator/objective "
                             f"series expected in the corpus")
    for (service, indicator), names in corpus["names_seen"].items():
        h = hll_ref.HLL()
        for n in names:
            h.insert(b"n%d" % n)
        key = ("ssf.names_unique", (f"indicator:{str(indicator).lower()}",
                                    "root_span:true", f"service:svc{service}"))
        if tagged.get(key) != float(hll_ref.estimate_from_registers(h.regs)):
            bad.append((key, tagged.get(key), sorted(names)))
    if bad:
        raise AssertionError(f"phase I1: {len(bad)} derived series wrong, "
                             f"e.g. {bad[:3]}")
    return checked + 3 * len(series) + len(corpus["names_seen"])


def _phase_i1() -> dict:
    corpora = [_i1_corpus(seed) for seed in PHASE_I1_SEEDS]
    server = _i_server({"ssf_listen_addresses": ["udp://127.0.0.1:0"],
                        "statsd_listen_addresses": [],
                        "indicator_span_timer_name": "sli.t",
                        "objective_span_timer_name": "slo.t"},
                       {"counter_capacity": 65536, "gauge_capacity": 32768,
                        "histo_capacity": 32768, "set_capacity": 16384})
    # every span derives its ssf.names_unique sample, so the estimate is
    # deterministic (tests/test_native_ingest.py:340)
    server.metric_extraction.uniqueness_rate = 1.0
    _zero_launches()
    server.start()
    try:
        addr = server.ssf_addresses[0]
        rcvbuf, window = _i_window(server._ssf_listeners[0],
                                   corpora[0]["dgrams"])
        report = {"intervals": [], "rcvbuf_bytes": rcvbuf,
                  "window_datagrams": window}
        base = 0
        seen = _read_launches()
        for corpus in corpora:
            n = len(corpus["dgrams"])
            ingest_s = _send_ssf(server, addr, corpus["dgrams"], base,
                                 window, PHASE_I_SENDERS)
            base += n
            stats = server.stats_snapshot()
            if stats["ingest_dispatch_errors"] or stats["spans_dropped"]:
                raise AssertionError(f"phase I1: {stats}")
            server.flush()
            now = _read_launches()
            tagged, got, _ = _collect_tagged(server.metric_sinks[0])
            report["intervals"].append({
                "datagrams": n, "samples": corpus["samples"],
                "ingest_s": ingest_s, "spans_per_s": n / ingest_s,
                "samples_per_s": corpus["samples"] / ingest_s,
                "flush": dict(server.last_flush_timings),
                "launches": {k: now[k] - seen[k] for k in now},
                "series_checked": _check_i1(corpus, tagged, got)})
            seen = now
    finally:
        server.shutdown()
    stats = server.stats_snapshot()
    report["stats"] = stats
    report["launches"] = _read_launches()
    if stats["ssf_packets_received"] != base \
            or stats["ssf_parse_errors"] != PHASE_I_BAD * len(corpora):
        raise AssertionError(f"phase I1: SSF packets {stats}")
    for kernel in ("tdigest_flush", "hll_estimate"):
        if report["launches"][kernel] <= 0:
            raise AssertionError(f"phase I1: {kernel} was not launched")
    return report


def _i2_traffic(interval: int):
    """Phase I2's spans: each carries one counter and one timer sample
    over a tenth of I1's keys; returns the wire bytes per transport and
    the expected counter sums and timer samples."""
    rng = np.random.default_rng(100 + interval)
    total = sum(PHASE_I2_SPANS.values())
    ckeys = rng.integers(0, PHASE_I2_KEYS["counter"], total)
    cvals = rng.integers(1, 100, total)
    tkeys = rng.integers(0, PHASE_I2_KEYS["timer"], total)
    tvals = rng.gamma(2.0, 25.0, total).astype(np.float32)
    c_heads = [_ssf_head(0, f"fan.c{k}")
               for k in range(PHASE_I2_KEYS["counter"])]
    t_heads = [_ssf_head(2, f"fan.t{k}")
               for k in range(PHASE_I2_KEYS["timer"])]
    spans = [_ssf_span(interval * 1_000_000 + i + 1, _I_T0 + i, 1000 + i,
                       b"fan-svc", b"fan-op",
                       (_ssf_sample(c_heads[ckeys[i]], float(cvals[i])),
                        _ssf_sample(t_heads[tkeys[i]], float(tvals[i]))))
             for i in range(total)]
    counters = np.bincount(ckeys, weights=cvals,
                           minlength=PHASE_I2_KEYS["counter"])
    timers: dict = {}
    for k, v in zip(tkeys.tolist(), tvals.tolist()):
        timers.setdefault(k, []).append(v)
    cut = np.cumsum([PHASE_I2_SPANS[t] for t in ("udp", "unix", "tcp")])
    return ({"udp": spans[:cut[0]], "unix": spans[cut[0]:cut[1]],
             "tcp": spans[cut[1]:]}, counters, timers)


def _i2_stream(address, unix: bool, spans) -> None:
    from veneur_tpu_torch import ssf, trace
    backend = trace.StreamBackend(address, unix=unix)
    try:
        for data in spans:
            backend.send(ssf.SSFSpan.FromString(data))
    finally:
        backend.close()


# the service of a server's own flush spans (the self-trace plane)
_SELF_SERVICE = "veneur-tpu"


def _check_i2(server, sinks, fake, producer, interval, counters,
              timers) -> dict:
    """Every span reached every sink exactly once (by id), the datadog
    fake holds the sink's own rendering of the channel sink's spans, the
    kafka records decode to those spans, and the metrics are exact. The
    server's own flush spans (service veneur-tpu), which reach the sinks
    too, are left out of the comparison."""
    from veneur_tpu_torch import ssf
    dd, _kafka, chan = sinks
    spans = [s for s in chan.queue.get(timeout=600)
             if s.service != _SELF_SERVICE]
    want_ids = list(range(interval * 1_000_000 + 1,
                          interval * 1_000_000 + 1
                          + sum(PHASE_I2_SPANS.values())))
    ids = sorted(s.id for s in spans)
    if ids != want_ids:
        raise AssertionError(f"phase I2: the channel sink took {len(ids)} "
                             f"spans, {len(set(ids))} distinct")
    bodies = fake.take()
    dd_spans = [s for _path, _enc, body in bodies
                for trace in json.loads(body) for s in trace
                if s.get("service") != _SELF_SERVICE]
    rendered = sorted(json.dumps(dd._to_dd_span(s), sort_keys=True)
                      for s in spans)
    if sorted(json.dumps(s, sort_keys=True) for s in dd_spans) != rendered:
        raise AssertionError(f"phase I2: datadog received {len(dd_spans)} "
                             f"spans unlike the sink's rendering")
    by_id = {s.id: s for s in spans}
    records = [r for r in producer.messages
               if ssf.SSFSpan.FromString(r[2]).service != _SELF_SERVICE]
    del producer.messages[:]
    kafka_ids = sorted(ssf.SSFSpan.FromString(v).id for _t, _k, v in records)
    if kafka_ids != want_ids or any(
            ssf.SSFSpan.FromString(v) != by_id[ssf.SSFSpan.FromString(v).id]
            for _t, _k, v in records):
        raise AssertionError("phase I2: kafka records differ from the spans")
    tagged, got, _ = _collect_tagged(server.metric_sinks[0])
    bad = [k for k in range(len(counters))
           if got.get(f"fan.c{k}", 0.0) != float(counters[k])]
    for k, vals in timers.items():
        have = tuple(got.get(f"fan.t{k}.{a}") for a in ("count", "min",
                                                        "max"))
        if have != (float(len(vals)), min(vals), max(vals)):
            bad.append((k, have))
    if bad:
        raise AssertionError(f"phase I2: {len(bad)} span metrics wrong, "
                             f"e.g. {bad[:3]}")
    return {"spans_per_sink": len(spans), "datadog_bodies": len(bodies),
            "datadog_body_bytes": sum(len(b) for *_x, b in bodies),
            "kafka_records": len(records),
            "series_checked": len(counters) + 3 * len(timers)}


def _phase_i2() -> dict:
    import shutil
    import tempfile
    import threading
    from veneur_tpu_torch.sinks.channel import ChannelSpanSink
    from veneur_tpu_torch.sinks.kafka import InMemoryProducer, KafkaSpanSink
    fake = _Fake()
    tmp = tempfile.mkdtemp(prefix="smoke-i2-")
    producer = InMemoryProducer()
    kafka = KafkaSpanSink("kafka", producer, span_topic="spans",
                          max_buffered=1 << 18)
    chan = ChannelSpanSink("channel")
    server = _i_server({
        "ssf_listen_addresses": ["udp://127.0.0.1:0",
                                 f"unix://{tmp}/ssf.sock",
                                 "tcp://127.0.0.1:0"],
        "statsd_listen_addresses": [],
        "span_sinks": [{"kind": "datadog", "name": "datadog", "config": {
            "datadog_trace_api_address": fake.url,
            "datadog_span_buffer_size": 1 << 17}}],
        "num_span_workers": 4, "span_channel_capacity": 65536,
        "span_sink_queue_capacity": 262144},
        {"counter_capacity": 8192, "histo_capacity": 8192},
        span_sinks=[kafka, chan])
    dd = next(s for s in server.span_sinks if s.kind() == "datadog")
    _zero_launches()
    server.start()
    try:
        udp, unix, tcp = server.ssf_addresses
        report = {"intervals": []}
        base = 0
        for interval in (1, 2):
            spans, counters, timers = _i2_traffic(interval)
            busy0 = server.span_worker_seconds
            t0 = time.perf_counter()
            _, window = _i_window(server._ssf_listeners[0], spans["udp"])
            udp_s = _send_ssf(server, udp, spans["udp"], base, window, 4)
            streams = [threading.Thread(
                target=_i2_stream, args=(unix, True, spans["unix"][j::4]))
                for j in range(PHASE_I2_STREAMS)]
            streams.append(threading.Thread(
                target=_i2_stream, args=(tcp, False, spans["tcp"])))
            for t in streams:
                t.start()
            for t in streams:
                t.join(timeout=300)
            base += sum(len(v) for v in spans.values())
            deadline = time.monotonic() + 120
            while server.stats["ssf_packets_received"] < base:
                if time.monotonic() > deadline:
                    raise AssertionError("phase I2: framed spans lost")
                time.sleep(0.001)
            server.drain_spans(timeout=300)
            delivered_s = time.perf_counter() - t0
            stats = server.stats_snapshot()
            drops = {k: v for k, v in stats.items()
                     if k == "spans_dropped" or k.startswith(
                         "span_sink_dropped")}
            if any(drops.values()) or stats["ingest_dispatch_errors"]:
                raise AssertionError(f"phase I2: drops {drops}, {stats}")
            server.flush()
            rec = _check_i2(server, (dd, kafka, chan), fake, producer,
                            interval, counters, timers)
            flush = server.last_flush_timings
            report["intervals"].append({
                "spans": sum(PHASE_I2_SPANS.values()),
                "udp_send_s": udp_s, "delivered_s": delivered_s,
                "spans_per_s": sum(PHASE_I2_SPANS.values()) / delivered_s,
                "span_worker_s": server.span_worker_seconds - busy0,
                "flush": dict(flush), **rec})
    finally:
        server.shutdown()
        fake.close()
        shutil.rmtree(tmp, ignore_errors=True)
    report["stats"] = server.stats_snapshot()
    report["launches"] = _read_launches()
    if report["launches"]["tdigest_flush"] <= 0:
        raise AssertionError("phase I2: tdigest_flush was not launched")
    return report


def _i3_traffic(seed: int) -> dict:
    cfg = PHASE_I3
    rng = np.random.default_rng(seed)
    tcp_lines = []
    ckeys = rng.integers(0, cfg["tcp_counter_keys"],
                         cfg["tcp_counter_lines"])
    cvals = rng.integers(1, 50, cfg["tcp_counter_lines"])
    tcp_lines += [f"tcp.c{k}:{v}|c" for k, v in zip(ckeys, cvals)]
    expect = {f"tcp.c{k}": float(v) for k, v in enumerate(np.bincount(
        ckeys, weights=cvals)) if v}
    tcp_ll = _llhist_lines(rng, tcp_lines, "tcp.l", cfg["tcp_ll_keys"],
                           cfg["tcp_ll_samples"])
    tcp_lines = [tcp_lines[i] for i in rng.permutation(len(tcp_lines))]
    unix_lines: list = []
    unix_ll = _llhist_lines(rng, unix_lines, "ux.l", cfg["unix_ll_keys"],
                            cfg["unix_ll_samples"])
    unix_lines = [unix_lines[i] for i in rng.permutation(len(unix_lines))]
    n = cfg["grpc_packets"] * cfg["grpc_lines"]
    gkeys = rng.integers(0, cfg["grpc_keys"], n)
    packets = [("\n".join(f"grpc.c{k}:1|c" for k in gkeys[
        i:i + cfg["grpc_lines"]])).encode()
        for i in range(0, n, cfg["grpc_lines"])]
    expect.update({f"grpc.c{k}": float(v) for k, v in enumerate(
        np.bincount(gkeys)) if v})
    heads = [_ssf_head(0, f"gspan.c{k}") for k in range(cfg["grpc_span_keys"])]
    spans = [_ssf_span(seed * 100_000 + i + 1, _I_T0 + i, 10, b"grpc-svc",
                       b"g", (_ssf_sample(heads[i % len(heads)], 1.0),))
             for i in range(cfg["grpc_spans"])]
    expect.update({f"gspan.c{k}": float(cfg["grpc_spans"] // len(heads))
                   for k in range(len(heads))})
    return {"tcp": tcp_lines, "unix": unix_lines, "packets": packets,
            "spans": spans, "expect": expect, "llhists": [tcp_ll, unix_ll]}


def _i3_tcp(address, lines) -> None:
    with socket.create_connection(address, timeout=60) as conn:
        conn.sendall(("\n".join(lines) + "\n").encode())


def _i3_emit(statsd_port: int, ssf_port: int, import_address: str) -> dict:
    """Three veneur-emit runs as an operator makes them: a DogStatsD
    counter, an SSF timer and a metric over the gRPC forward plane."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    runs = (["-hostport", f"udp://127.0.0.1:{statsd_port}", "-name",
             "emit.c", "-count", "5"],
            ["-ssf", "-hostport", f"udp://127.0.0.1:{ssf_port}", "-name",
             "emit.t", "-timing", "40ms"],
            ["-grpc", "-hostport", import_address, "-name", "emit.fwd",
             "-count", "7"])
    seconds = []
    for argv in runs:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m",
                        "veneur_tpu_torch.cmd.veneur_emit", *argv],
                       check=True, cwd=ROOT, env=env, timeout=300)
        seconds.append(time.perf_counter() - t0)
    return {"emit.c": 5.0, "emit.t.max": 40.0, "emit.t.count": 1.0,
            "emit.fwd": 7.0, "seconds": seconds}


def _phase_i3() -> dict:
    import shutil
    import tempfile
    import threading
    import grpc
    from veneur_tpu_torch.core.protos import dogstatsd_pb2
    tmp = tempfile.mkdtemp(prefix="smoke-i3-")
    cfg = PHASE_I3
    server = _i_server({
        "statsd_listen_addresses": ["udp://127.0.0.1:0", "tcp://127.0.0.1:0",
                                    f"unixgram://{tmp}/statsd.sock"],
        "ssf_listen_addresses": ["udp://127.0.0.1:0"],
        "grpc_listen_addresses": ["127.0.0.1:0"],
        "grpc_address": "127.0.0.1:0"},
        {"counter_capacity": 16384, "histo_capacity": 1024,
         "llhist_capacity": 8192})
    _zero_launches()
    server.start()
    try:
        udp, tcp, unix = server.listen_addresses
        ssf_udp = server.ssf_addresses[0]
        ingest = server.grpc_ingest_servers[0].address
        report = {"intervals": []}
        lines = spans_in = 0
        seen = _read_launches()
        for interval in (1, 2):
            traffic = _i3_traffic(300 + interval)
            t0 = time.perf_counter()
            conns = [threading.Thread(target=_i3_tcp, args=(
                tcp, traffic["tcp"][j::cfg["tcp_conns"]]))
                for j in range(cfg["tcp_conns"])]
            for t in conns:
                t.start()
            # the UNIX datagrams from a connected socket, paced so the
            # socket's queue never fills: the card's host (a gVisor
            # sandbox) delivers no unconnected sendto to a UNIX datagram
            # path and can miss the wakeup of a sender blocked on a full
            # queue, so a send that times out is sent again (a datagram
            # is queued whole or not at all)
            with socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM) as tx:
                tx.settimeout(0.2)
                tx.connect(unix)
                dgrams, counts = _datagrams(traffic["unix"])
                sent = lines + len(traffic["tcp"])
                for dgram, n in zip(dgrams, counts):
                    deadline = time.monotonic() + 60.0
                    while sent - server.stats["lines_received"] > 4_000:
                        if time.monotonic() > deadline:
                            raise AssertionError("phase I3: UNIX stalled")
                        time.sleep(0.0005)
                    while True:
                        try:
                            tx.send(dgram)
                            break
                        except TimeoutError:
                            if time.monotonic() > deadline:
                                raise
                    sent += n
            unix_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            with grpc.insecure_channel(ingest) as chan:
                send_packet = chan.unary_unary(
                    "/dogstatsd.DogstatsdGRPC/SendPacket",
                    request_serializer=lambda b: dogstatsd_pb2.
                    DogstatsdPacket(packetBytes=b).SerializeToString(),
                    response_deserializer=lambda b: b)
                send_span = chan.unary_unary(
                    "/ssf.SSFGRPC/SendSpan", request_serializer=lambda b: b,
                    response_deserializer=lambda b: b)
                for p in traffic["packets"]:
                    send_packet(p, timeout=60)
                for sp in traffic["spans"]:
                    send_span(sp, timeout=60)
            grpc_s = time.perf_counter() - t1
            for t in conns:
                t.join(timeout=300)
            lines = sent + cfg["grpc_packets"] * cfg["grpc_lines"]
            spans_in += cfg["grpc_spans"]
            expect = dict(traffic["expect"])
            emitted = {}
            if interval == 1:
                emitted = _i3_emit(udp[1], ssf_udp[1],
                                   server.import_server.address)
                lines += 1
                spans_in += 1
            deadline = time.monotonic() + 120
            while True:
                stats = server.stats_snapshot()
                if (stats["lines_received"] >= lines
                        and stats["ssf_packets_received"] >= spans_in
                        and stats["imported_total"] >= 1):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase I3: traffic lost: {stats}")
                time.sleep(0.001)
            server.drain_spans(timeout=120)
            ingest_s = time.perf_counter() - t0
            if stats["lines_received"] != lines or stats["lines_rejected"] \
                    or stats["ingest_dispatch_errors"]:
                raise AssertionError(f"phase I3: {stats} against {lines}")
            server.flush()
            now = _read_launches()
            tagged, got, buckets = _collect_tagged(server.metric_sinks[0])
            _check_exact(got, expect)
            checked = len(expect)
            for prefix, vals, weights in traffic["llhists"]:
                checked += _check_llhists(got, buckets, prefix, vals,
                                          weights)
            for name in ("emit.c", "emit.t.max", "emit.t.count",
                         "emit.fwd"):
                if name in emitted and got.get(name) != emitted[name]:
                    raise AssertionError(f"phase I3: {name} = "
                                         f"{got.get(name)}, sent "
                                         f"{emitted[name]}")
            report["intervals"].append({
                "tcp_lines": len(traffic["tcp"]),
                "unix_lines": len(traffic["unix"]),
                "grpc_lines": cfg["grpc_packets"] * cfg["grpc_lines"],
                "grpc_spans": cfg["grpc_spans"], "unix_send_s": unix_s,
                "grpc_s": grpc_s, "ingest_s": ingest_s,
                "emit_s": emitted.get("seconds"),
                "flush": dict(server.last_flush_timings),
                "launches": {k: now[k] - seen[k] for k in now},
                "series_checked": checked + (4 if emitted else 0)})
            seen = now
    finally:
        server.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    report["stats"] = server.stats_snapshot()
    report["launches"] = _read_launches()
    for kernel in ("tdigest_flush", "llhist_apply"):
        if report["launches"][kernel] <= 0:
            raise AssertionError(f"phase I3: {kernel} was not launched")
    return report


def _phase_i() -> dict:
    """Phase I: the SSF plane at full width (I1), the span fan-out (I2)
    and the other listeners (I3). Each part zeroes the launch counts
    just before it and reads them just after; the phase's launches are
    their sum."""
    t0 = time.perf_counter()
    parts = {}
    for name, run in (("I1", _phase_i1), ("I2", _phase_i2),
                      ("I3", _phase_i3)):
        parts[name] = run()
        torch.cuda.empty_cache()
    launches = {k: sum(p["launches"][k] for p in parts.values())
                for k in parts["I1"]["launches"]}
    return {**parts, "launches": launches,
            "seconds": time.perf_counter() - t0}


# -- phase J: the overload plane and the self-trace plane --------------------

PHASE_J_LL_KEYS = 5_000
# one traced flush and one untraced (four, 1 0 1 0, before the smoke's
# time limit asked for the depth)
PHASE_J5_RATES = (1.0, 0.0)
PHASE_J_RATE = 100_000        # ingest_rate_limit_statsd, samples/s
PHASE_J_SEND_RATE = 200_000   # J1's senders, lines/s: twice the limit
PHASE_J_SPANS = 2_000         # SSF spans per J2 interval
PHASE_J_GIB = 1 << 30
PHASE_J3_KEYS = PHASE_C_KEYS  # a tenth of phase A's keys
PHASE_J3_LEAK = 1_000
PHASE_J4_KEYS = PHASE_C_KEYS
PHASE_J4_LL_KEYS = PHASE_D_LL_KEYS // 10
_J_CAPS = {"counter_capacity": 65536, "gauge_capacity": 32768,
           "histo_capacity": 32768, "set_capacity": 16384,
           "llhist_capacity": 8192}


def _j_server(cfg_extra: dict, tpu: dict, sinks, span_sinks=(),
              seed: int = 17):
    """A Server on cuda:0 with the given metric and span sinks and its
    generator seeded with `seed` (servers of one trace need their own,
    or their span ids collide); the span extraction's uniqueness roll is
    off, so the server's own flush spans derive no metric and the sample
    identities stay exact."""
    import random
    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.core.server import Server
    cfg = config_from_dict({
        "statsd_listen_addresses": ["udp://127.0.0.1:0"],
        "interval": "1h", "percentiles": list(PS),
        "aggregates": ["min", "max", "count"],
        "read_buffer_size_bytes": 8 << 20, "hostname": "smoke",
        **cfg_extra, "tpu": {"batch_cap": 8192, **tpu}})
    server = Server(cfg, extra_metric_sinks=list(sinks),
                    extra_span_sinks=list(span_sinks),
                    rng=random.Random(seed))
    server.metric_extraction.uniqueness_rate = 0.0
    return server


def _send_at_rate(server, addr, lines, base: int, window: int,
                  rate: float) -> float:
    """_send, also paced to `rate` lines a second."""
    dgrams, counts = _datagrams(lines)
    sent = base
    t0 = time.perf_counter()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        for dgram, n in zip(dgrams, counts):
            ahead = (sent - base) / rate - (time.perf_counter() - t0)
            if ahead > 0:
                time.sleep(ahead)
            deadline = time.monotonic() + 30.0
            while sent - server.stats["lines_received"] > window:
                if time.monotonic() > deadline:
                    raise AssertionError("server stopped receiving lines")
                time.sleep(0.0005)
            sock.sendto(dgram, addr)
            sent += n
    deadline = time.monotonic() + 60.0
    while server.stats["lines_received"] < sent:
        if time.monotonic() > deadline:
            raise AssertionError(
                f"lines lost on loopback: sent {sent}, received "
                f"{server.stats['lines_received']}")
        time.sleep(0.001)
    return time.perf_counter() - t0


def _j_sent(keys: dict, ll_keys: int) -> dict:
    """Samples sent per shed class in one phase A interval."""
    return {"essential": keys["counter"] + 2 * keys["gauge"],
            "histogram": keys["timer"] * keys["timer_samples"]
            + ll_keys * 32,
            "set": keys["set"] * keys["set_members"]}


def _j_ledger(server) -> dict:
    """The last closed ledger interval's stage totals: admitted, shed by
    class and reason, applied by family."""
    rec = server.ledger.report(intervals=1)["intervals"][-1]
    stages = rec["stages"]
    return {"admitted": sum(stages.get("ingest.admitted", {}).values()),
            "shed": dict(stages.get("ingress.shed", {})),
            "applied": dict(stages.get("agg.applied", {})),
            "imbalance": rec["imbalance"]}


def _j_kept_histograms(got: dict, keys: dict, ll_keys: int,
                       ll_weights) -> int:
    """Histogram-class samples the flush shows kept: every timer key's
    `.count` and every llhist key's `.count` over its sample weight."""
    kept = sum(got.get(f"smoke.t{k}.count", 0.0)
               for k in range(keys["timer"]))
    kept += sum(got.get(f"smoke.l{k}.count", 0.0) / ll_weights[k]
                for k in range(ll_keys))
    return int(round(kept))


def _j_shed_of(shed: dict, cls: str, reason: str = "") -> int:
    return int(sum(v for k, v in shed.items()
                   if k.split("|")[0] == cls
                   and (not reason or k.endswith("|" + reason))))


def _phase_j1() -> dict:
    """J1: admission under a statsd rate limit of 100 000 samples/s with
    senders paced to twice that, two intervals of phase A's corpus plus
    5 000 `|l` keys x 32; counters and gauges exact, the histogram and
    set identities exact, the strict ledger balanced, no stall."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    keys = PHASE_A_KEYS
    sent = _j_sent(keys, PHASE_J_LL_KEYS)
    server = _j_server({"ingest_rate_limit_statsd": PHASE_J_RATE,
                        "ingest_rate_limit_burst": "1s",
                        "supervisor_deadline": "5s",
                        "ledger_strict": True}, _J_CAPS,
                       [ChannelMetricSink()])
    corpora = [_corpus(seed, keys, PHASE_J_LL_KEYS) for seed in (41, 42)]
    _zero_launches()
    server.start()
    report = {"intervals": []}
    try:
        # whether this host's /proc/net/udp lists the pump's sockets,
        # without which ingest.kernel_drops reads nothing
        drops = server.overload.kernel_drops
        listed = drops._read_proc()
        report["kernel_drops_visible"] = bool(drops._watched) and all(
            inode in listed for inode in drops._watched)
        window = _pump_window(server)
        base = 0
        seen = _read_launches()
        for i, (lines, expect, timers, llhists) in enumerate(corpora):
            ingest_s = _send_at_rate(server, server.listen_addresses[0],
                                     lines, base, window, PHASE_J_SEND_RATE)
            base += len(lines)
            stats = server.stats_snapshot()
            if stats["lines_received"] != base or \
                    stats["ingest_dispatch_errors"]:
                raise AssertionError(f"phase J1: {stats}")
            server.flush()  # ledger_strict: an imbalance raises here
            now = _read_launches()
            got, _buckets = _collect(server.metric_sinks[0])
            _check_exact(got, expect)
            led = _j_ledger(server)
            shed = led["shed"]
            if led["admitted"] + sum(shed.values()) != len(lines):
                raise AssertionError(
                    f"phase J1 interval {i + 1}: admitted "
                    f"{led['admitted']} + shed {sum(shed.values())} != "
                    f"sent {len(lines)}")
            kept_h = _j_kept_histograms(got, keys, PHASE_J_LL_KEYS,
                                        llhists[2])
            shed_h = _j_shed_of(shed, "histogram")
            if kept_h + shed_h != sent["histogram"]:
                raise AssertionError(
                    f"phase J1 interval {i + 1}: histogram kept {kept_h} "
                    f"+ shed {shed_h} != sent {sent['histogram']}")
            kept_s = int(led["applied"].get("set", 0))
            shed_s = _j_shed_of(shed, "set")
            if kept_s + shed_s != sent["set"]:
                raise AssertionError(
                    f"phase J1 interval {i + 1}: set kept {kept_s} + shed "
                    f"{shed_s} != sent {sent['set']}")
            if i == 1 and not shed.get("histogram|rate_limit"):
                raise AssertionError("phase J1: nothing over the limit")
            report["intervals"].append({
                "lines": len(lines), "ingest_s": ingest_s,
                "lines_per_s": len(lines) / ingest_s,
                "flush": dict(server.last_flush_timings),
                "launches": {k: now[k] - seen[k] for k in now},
                "shed": shed, "admitted": led["admitted"],
                "histogram_kept": kept_h, "set_kept": kept_s,
                "series_checked": len(expect)})
            seen = now
        sup = server.overload.supervisor
        stalls, probes = sup.counts_snapshot()
        report["max_heartbeat_age_s"] = sup.max_heartbeat_ages()
        report["pump_stall_probes"] = probes
    finally:
        server.shutdown()
    report["launches"] = _read_launches()
    if any(stalls.values()):
        raise AssertionError(f"phase J1: supervisor stalls {stalls} (max "
                             f"heartbeat ages "
                             f"{report['max_heartbeat_age_s']})")
    for kernel in ("tdigest_flush", "hll_estimate", "llhist_apply"):
        if report["launches"][kernel] <= 0:
            raise AssertionError(f"phase J1: {kernel} was not launched")
    return report


def _j_spans(interval: int) -> list:
    """PHASE_J_SPANS SSF spans without metrics, service smoke-j."""
    base = interval * 1_000_000
    return [_ssf_span(base + i, 1_700_000_000_000_000_000 + i, 1000,
                      b"smoke-j", b"op", []) for i in range(PHASE_J_SPANS)]


def _j_dense_from_calls(calls, meta) -> dict:
    """name -> dense llhist registers summed from the recorded K3 table
    applies (rows, bins, weights)."""
    from veneur_tpu_torch.ops import llhist_ref as ref
    out: dict = {}
    for rows, bins, wts in calls:
        for row in np.unique(rows):
            sel = rows == row
            dense = out.setdefault(meta[int(row)].name,
                                   np.zeros(ref.BINS, np.int64))
            np.add.at(dense, bins[sel], wts[sel].astype(np.int64))
    return out


def _j_check_bins(got: dict, buckets: dict, dense: dict) -> int:
    """Every llhist key's `.count` and `.bucket` lines equal to the
    registers rebuilt on the host from the columns K3 applied."""
    from veneur_tpu_torch.ops import llhist_ref as ref
    bad = []
    for name, regs in dense.items():
        c_sorted = regs[ref.ORDER]
        cum = np.cumsum(c_sorted)
        want = {f"le:{_fmt_le(ref.UPPER_SORTED[s])}": float(cum[s])
                for s in np.flatnonzero(c_sorted)}
        want["le:+Inf"] = float(regs.sum())
        if buckets.get(f"{name}.bucket") != want:
            bad.append((name, "bucket"))
        if got.get(f"{name}.count") != float(regs.sum()):
            bad.append((name, "count"))
    if bad:
        raise AssertionError(f"phase J2: {len(bad)} llhist series unlike "
                             f"the strided K3 input, e.g. {bad[:3]}")
    return 2 * len(dense)


def _phase_j2() -> dict:
    """J2: the watermark ladder on one server, four intervals of phase
    A's corpus plus 5 000 `|l` keys x 32 and 2 000 SSF spans each:
    ok, degraded (stride 4), shedding, ok, driven by simulated pressure
    over thresholds set from the RSS after start."""
    from veneur_tpu_torch.core import overload as ov
    from veneur_tpu_torch.core.columnstore import LLHistTable
    from veneur_tpu_torch.sinks.channel import (ChannelMetricSink,
                                                ChannelSpanSink)
    keys = PHASE_A_KEYS
    sent = _j_sent(keys, PHASE_J_LL_KEYS)
    chan = ChannelSpanSink("channel")
    server = _j_server({"ssf_listen_addresses": ["udp://127.0.0.1:0"],
                        "http_address": "127.0.0.1:0",
                        "overload_watermark_poll": "100ms",
                        "chaos_enabled": True, "ledger_strict": True,
                        "span_channel_capacity": 8192}, _J_CAPS,
                       [ChannelMetricSink()], [chan])
    ladder = (("ok", 0), ("degraded", 24), ("shedding", 40), ("ok", 0))
    seeds = (51, 52, 53, 54)
    _zero_launches()
    server.start()
    report = {"intervals": []}
    calls: list = []
    real_add = LLHistTable.add_batch_binned

    def recording_add(rows, bins, wts, clamped=0):
        calls.append((np.array(rows), np.array(bins), np.array(wts)))
        return real_add(server.store.llhists, rows, bins, wts, clamped)
    try:
        from veneur_tpu_torch.core.overload import current_rss_bytes
        rss0 = current_rss_bytes()
        wm = server.overload.watermarks
        wm.soft_bytes = rss0 + 16 * PHASE_J_GIB
        wm.hard_bytes = rss0 + 32 * PHASE_J_GIB
        report["rss_after_start"] = rss0
        window = _pump_window(server)
        ssf_addr = server.ssf_addresses[0]
        base = span_base = 0
        seen = _read_launches()
        for i, ((state, gib), seed) in enumerate(zip(ladder, seeds)):
            server.chaos.set_simulated_rss(gib * PHASE_J_GIB)
            deadline = time.monotonic() + 30.0
            while wm.state != state:
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase J2: the ladder never "
                                         f"reached {state}")
                time.sleep(0.01)
            # the previous flush's own spans settle before the count
            server.trace_client.flush()
            server.drain_spans(timeout=120)
            shed0 = server.overload.shed_snapshot()
            lines, expect, timers, llhists = _corpus(seed, keys,
                                                     PHASE_J_LL_KEYS)
            if state == "degraded":
                calls.clear()
                server.store.llhists.add_batch_binned = recording_add
            ingest_s = _send(server, server.listen_addresses[0], lines,
                             base, window)
            base += len(lines)
            spans = _j_spans(i + 1)
            _send_ssf(server, ssf_addr, spans, span_base, 256, 1)
            span_base += len(spans)
            server.drain_spans(timeout=120)
            if state == "degraded":
                del server.store.llhists.add_batch_binned
            shed = {k: v - shed0.get(k, 0)
                    for k, v in server.overload.shed_snapshot().items()}
            ready = _http(server.http_api.address, "/healthcheck/ready")
            stats = server.stats_snapshot()
            if stats["lines_received"] != base or \
                    stats["ingest_dispatch_errors"]:
                raise AssertionError(f"phase J2: {stats}")
            server.flush()
            now = _read_launches()
            got, buckets = _collect(server.metric_sinks[0])
            _check_exact(got, expect)
            led = _j_ledger(server)
            rec = {"state": state, "lines": len(lines),
                   "ingest_s": ingest_s,
                   "lines_per_s": len(lines) / ingest_s,
                   "flush": dict(server.last_flush_timings),
                   "launches": {k: now[k] - seen[k] for k in now},
                   "shed": shed, "ledger_shed": led["shed"]}
            seen = now
            own = [s for s in chan.queue.get(timeout=600)
                   if s.service == "smoke-j"]
            if state == "ok":
                set_ref = _set_reference(seed, keys["set"],
                                         keys["set_members"])
                checked = len(expect) + _check_timers(got, timers)
                _check_sets(got, set_ref, keys["set_members"])
                checked += keys["set"] + _check_llhists(got, buckets,
                                                        *llhists)
                if any(shed.values()) or len(own) != PHASE_J_SPANS:
                    raise AssertionError(f"phase J2 interval {i + 1}: shed "
                                         f"{shed}, {len(own)} spans")
                if ready[0] != 200:
                    raise AssertionError(f"phase J2: not ready in ok")
            else:
                checked = len(expect)
                if own or shed.get("span|overload") != PHASE_J_SPANS:
                    raise AssertionError(
                        f"phase J2 interval {i + 1}: spans not shed: "
                        f"{len(own)} delivered, shed {shed}")
            if state == "degraded":
                for cls in ("histogram", "set"):
                    fam = ("histogram", "llhist") if cls == "histogram" \
                        else ("set",)
                    kept = int(sum(led["applied"].get(f, 0) for f in fam))
                    if kept + shed.get(f"{cls}|degraded", 0) != sent[cls]:
                        raise AssertionError(
                            f"phase J2 degraded: {cls} kept {kept} + shed "
                            f"{shed} != sent {sent[cls]}")
                kept_h = _j_kept_histograms(got, keys, PHASE_J_LL_KEYS,
                                            llhists[2])
                if kept_h != int(led["applied"].get("histogram", 0)
                                 + led["applied"].get("llhist", 0)):
                    raise AssertionError("phase J2 degraded: the flushed "
                                         "counts differ from the applied")
                dense = _j_dense_from_calls(calls,
                                            server.store.llhists.meta)
                checked += _j_check_bins(got, buckets, dense)
                rec["k3_strided_calls"] = len(calls)
                calls.clear()
            if state == "shedding":
                leaked = [n for n in list(got) + list(buckets)
                          if n.startswith(("smoke.t", "smoke.s",
                                           "smoke.l"))]
                if leaked:
                    raise AssertionError(f"phase J2 shedding flushed "
                                         f"{leaked[:3]}")
                body = json.loads(ready[1])
                want = (f"overload state {ov.SHEDDING} "
                        f"(rss {wm.last_rss} bytes)")
                if ready[0] != 503 or not body["reason"].startswith(
                        f"overload state {ov.SHEDDING} (rss "):
                    raise AssertionError(f"phase J2: ready {ready}")
                rec["ready"] = [ready[0], body["reason"], want]
            rec["series_checked"] = checked
            report["intervals"].append(rec)
        events = server.telemetry.events.snapshot(kind="overload_state")
        report["transitions"] = wm.transitions
        report["events"] = [(e["old"], e["new"]) for e in events]
    finally:
        server.shutdown()
    report["launches"] = _read_launches()
    if report["transitions"] != 3 or report["events"] != [
            ("ok", "degraded"), ("degraded", "shedding"),
            ("shedding", "ok")]:
        raise AssertionError(f"phase J2: transitions "
                             f"{report['transitions']}, events "
                             f"{report['events']}")
    for kernel in ("tdigest_flush", "hll_estimate", "llhist_apply"):
        if report["launches"][kernel] <= 0:
            raise AssertionError(f"phase J2: {kernel} was not launched")
    return report


def _phase_j3() -> dict:
    """J3: ingest chaos on the numpy batch path (where the datagrams
    pass the packet intake), a tenth of phase A's keys: drop, truncate
    and duplicate at 0.1 each from seed 7, then a run whose ledger leak
    drill drops every 1 000th slow-path sample."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    keys = PHASE_J3_KEYS
    report = {}
    for run, extra in (("mangle", {"chaos_ingest_drop_rate": 0.1,
                                   "chaos_ingest_truncate_rate": 0.1,
                                   "chaos_ingest_duplicate_rate": 0.1}),
                       ("leak", {"chaos_ledger_leak": PHASE_J3_LEAK})):
        server = _j_server({"chaos_enabled": True, "chaos_seed": 7,
                            **extra},
                           {"counter_capacity": 8192,
                            "gauge_capacity": 4096, "histo_capacity": 4096,
                            "set_capacity": 2048, "llhist_capacity": 1024,
                            "disable_native_parser": True},
                           [ChannelMetricSink()])
        chaos = server.chaos
        seen = {"in": 0, "out": 0, "lines": 0}
        real_mangle = chaos.mangle_packets

        def counting_mangle(batch, real=real_mangle, seen=seen):
            out = real(batch)
            seen["in"] += len(batch)
            seen["out"] += len(out)
            seen["lines"] += sum(1 for d in out for ln in d.split(b"\n")
                                 if ln)
            return out
        chaos.mangle_packets = counting_mangle
        lines = _corpus(61, keys, PHASE_C_LL_KEYS)[0]
        dgrams, _counts = _datagrams(lines)
        _zero_launches()
        server.start()
        try:
            addr = server.listen_addresses[0]
            t0 = time.perf_counter()
            if run == "leak":  # nothing is lost: pace by lines received
                _send(server, addr, lines, 0, PY_WINDOW)
                seen["in"] = seen["out"] = len(dgrams)
                seen["lines"] = len(lines)
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
                for j, dgram in enumerate(dgrams if run == "mangle"
                                          else ()):
                    deadline = time.monotonic() + 30.0
                    while j - seen["in"] > 64:
                        if time.monotonic() > deadline:
                            raise AssertionError("phase J3: the server "
                                                 "stopped reading")
                        time.sleep(0.0005)
                    sock.sendto(dgram, addr)
            deadline = time.monotonic() + 60.0
            while seen["in"] < len(dgrams):
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase J3: {seen['in']} of "
                                         f"{len(dgrams)} datagrams read")
                time.sleep(0.001)
            ingest_s = time.perf_counter() - t0
            deadline = time.monotonic() + 60.0
            while server.stats["lines_received"] < seen["lines"]:
                if time.monotonic() > deadline:
                    raise AssertionError("phase J3: lines not counted")
                time.sleep(0.001)
            server.flush()
            server.metric_sinks[0].wait_flush(timeout=600)
            faults = dict(chaos.packet_faults)
            rec = {"datagrams": len(dgrams), "lines": len(lines),
                   "ingest_s": ingest_s, "faults": faults,
                   "reached_parser": seen["out"],
                   "lines_received": server.stats["lines_received"],
                   "launches": _read_launches()}
            if run == "mangle":
                want = (len(dgrams) - faults.get("drop", 0)
                        + faults.get("duplicate", 0))
                if seen["out"] != want or not all(
                        faults.get(a) for a in ("drop", "truncate",
                                                "duplicate")):
                    raise AssertionError(f"phase J3: {seen['out']} "
                                         f"datagrams reached the parser, "
                                         f"want {want} ({faults})")
                if server.stats["lines_received"] != seen["lines"]:
                    raise AssertionError(f"phase J3: lines {rec}")
            else:
                led = server.ledger.report(intervals=1)["intervals"][-1]
                rec["imbalance"] = led["imbalance"]
                rec["leaked"] = chaos.leaked_samples
                if not chaos.leaked_samples or \
                        led["imbalance"]["ingest"] != chaos.leaked_samples:
                    raise AssertionError(f"phase J3: leak {rec}")
        finally:
            server.shutdown()
        report[run] = rec
    report["launches"] = {k: sum(r["launches"][k] for r in report.values())
                          for k in report["mangle"]["launches"]}
    return report


def _j_tree(tid: str, reports) -> dict:
    """The spans of trace `tid` across the tiers' /debug/traces reports,
    held to be one tree: one root (a local's flush), every other parent
    present. Returns the spans by id."""
    spans = [s for rep in reports for t in rep["traces"]
             if t["trace_id"] == tid for s in t["spans"]]
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans
             if not s["parent_id"] or s["parent_id"] not in by_id]
    if len(roots) != 1 or roots[0]["name"] != "flush":
        raise AssertionError(f"phase J4: trace {tid} has roots "
                             f"{[(r['name'], r['service']) for r in roots]}")
    return by_id


def _phase_j4() -> dict:
    """J4: phase D's topology at a tenth of its keys, local 2 through the
    port's proxy (its CLI, a process of its own), every tier at
    trace_self_sample_rate 1, two intervals: one trace per local and
    interval across /debug/traces of every tier, the self-spans at the
    channel span sinks, the `|l` exemplars on the global's bucket lines
    (and on the series of the names the locals' cardinality observatory
    put on their exemplar watch lists)."""
    import shutil
    import tempfile
    from veneur_tpu_torch.sinks.channel import (ChannelMetricSink,
                                                ChannelSpanSink)
    from veneur_tpu_torch.sinks.prometheus import PrometheusMetricSink
    keys = PHASE_J4_KEYS
    workdir = tempfile.mkdtemp(prefix="smoke-j4-")
    prom_port = _free_port()
    prom = PrometheusMetricSink("prometheus",
                                expose_address=f"127.0.0.1:{prom_port}")
    spans_at = {name: ChannelSpanSink("channel")
                for name in ("global", "local1", "local2")}
    caps = {"counter_capacity": 8192, "gauge_capacity": 8192,
            "histo_capacity": 8192, "set_capacity": 4096,
            "llhist_capacity": 2048}
    trace = {"trace_self_sample_rate": 1.0, "http_address": "127.0.0.1:0"}
    gserver = _j_server({"grpc_address": f"127.0.0.1:{_free_port()}",
                         "statsd_listen_addresses": [], **trace}, caps,
                        [ChannelMetricSink(), prom], [spans_at["global"]],
                        seed=70)
    _zero_launches()
    gserver.start()
    proxy = locals_ = None
    report = {"intervals": []}
    try:
        proxy = _Proxy([gserver.import_server.address], workdir,
                       extra={"trace_self_sample_rate": 1.0},
                       phase="phase J4")
        locals_ = [_j_server({"forward_address": address, **trace}, caps,
                             [ChannelMetricSink()], [spans_at[name]],
                             seed=seed)
                   for name, address, seed in (
                       ("local1", gserver.import_server.address, 71),
                       ("local2", proxy.grpc_address, 72))]
        for server in locals_:
            server.start()
        bases = [0, 0]
        seen = _read_launches()
        all_tids: list = []
        # OpenMetrics names of the locals' exemplar watch lists (the
        # cardinality observatory's top names, refreshed every flush)
        watched = set()
        for seed in (71, 72):
            parts, (g_expect, timers, ll_vals, ll_w, set_ref) = \
                _phase_d_interval(seed, keys, PHASE_J4_LL_KEYS)
            imported0 = gserver.import_server.imported_total
            for i, (server, part) in enumerate(zip(locals_, parts)):
                _send(server, server.listen_addresses[0], part[0],
                      bases[i], _pump_window(server))
                bases[i] += len(part[0])
            tids = []
            for server in locals_:
                server.flush()
                tids.append(server.telemetry.flushes.snapshot()[-1][
                    "trace_id"])
                watched.update(n.replace(".", "_")
                               for n in server.trace_plane._watch)
            all_tids.extend(tids)
            want = sum(s.stats_snapshot()["forwarded_total"]
                       for s in locals_)
            deadline = time.monotonic() + _H_TIMEOUT_S
            while gserver.import_server.imported_total < want:
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase J4: imported "
                                         f"{gserver.import_server.imported_total}"
                                         f" of {want}: {proxy.tail()}")
                time.sleep(0.01)
            gserver.flush()
            got, buckets = _collect(gserver.metric_sinks[0])
            checks = _check_global(got, buckets, g_expect, timers, ll_vals,
                                   ll_w, set_ref, 16 + keys["set_members"],
                                   "phase J4")
            greps = [json.loads(_http(s.http_api.address,
                                      f"/debug/traces?trace_id={t}")[1])
                     for s, t in zip(locals_, tids)]
            gtraces = [json.loads(_http(gserver.http_api.address,
                                        f"/debug/traces?trace_id={t}")[1])
                       for t in tids]
            ptrace = json.loads(proxy.get(
                f"/debug/traces?trace_id={tids[1]}"))
            trees = []
            gflush_under = []
            for j, tid in enumerate(tids):
                reps = [greps[j], gtraces[j]] + ([ptrace] if j else [])
                by_id = _j_tree(tid, reps)
                names = [s["name"] for s in by_id.values()]
                want_names = {"flush", "flush.family", "flush.sink",
                              "import.merge"}
                if j:
                    want_names |= {"proxy.route", "proxy.dest.send"}
                if not want_names <= set(names) or \
                        names.count("flush.family") < 6:
                    raise AssertionError(f"phase J4: local {j + 1}'s trace "
                                         f"holds {sorted(set(names))}")
                merges = [s for s in by_id.values()
                          if s["name"] == "import.merge"]
                for m in merges:
                    parent = by_id[m["parent_id"]]
                    if parent["name"] != ("proxy.dest.send" if j
                                          else "flush.sink"):
                        raise AssertionError(f"phase J4: import.merge "
                                             f"under {parent['name']}")
                gflush = [s for s in by_id.values() if s["name"] == "flush"
                          and s["tags"].get("mode") == "global"]
                for g in gflush:
                    if by_id[g["parent_id"]]["name"] != "import.merge":
                        raise AssertionError("phase J4: the global flush "
                                             "is not under the import")
                gflush_under.append(len(gflush))
                trees.append({"trace_id": tid, "spans": len(by_id),
                              "merges": len(merges),
                              "services": sorted({s["service"]
                                                  for s in by_id.values()})})
            # the global's flush adopts the latest fresh import's trace:
            # exactly one of the two locals' trees holds it
            if sorted(gflush_under) != [0, 1]:
                raise AssertionError(f"phase J4: global flush spans per "
                                     f"trace {gflush_under}")
            exemplars = gserver.trace_plane.exemplars.snapshot()
            om = prom.exposition_openmetrics()
            status, body = _http(("127.0.0.1", prom_port), "/metrics",
                                 accept="application/openmetrics-text")
            ex_lines = [ln for ln in om.splitlines() if "# {trace_id=" in ln]
            fams = {}
            for ln in ex_lines:
                fam = ln.split("{", 1)[0].split(" ", 1)[0]
                if not fam.endswith("_bucket") and fam not in watched:
                    raise AssertionError(f"phase J4: exemplar on {ln[:80]}")
                fams[fam] = fams.get(fam, 0) + 1
                if not any(f'trace_id="{t}"' in ln for t in all_tids):
                    raise AssertionError(f"phase J4: exemplar of another "
                                         f"trace: {ln[:120]}")
            if not ex_lines or any(n != 1 for n in fams.values()) or \
                    status != 200 or body.decode() != om:
                raise AssertionError(f"phase J4: exemplar lines "
                                     f"{len(ex_lines)}, per family "
                                     f"{set(fams.values())}, HTTP {status}")
            now = _read_launches()
            report["intervals"].append({
                "traces": trees, "series_checked":
                checks["series_checked"], "exemplar_lines": len(ex_lines),
                "global_exemplars": len(exemplars),
                "launches": {k: now[k] - seen[k] for k in now}})
            seen = now
        # the channel span sinks took the flushes' own spans
        for name, server in zip(("local1", "local2", "global"),
                                locals_ + [gserver]):
            server.trace_client.flush()
            server.drain_spans(timeout=120)
            server.flush()
            taken = []
            while not spans_at[name].queue.empty():
                taken.extend(spans_at[name].queue.get_nowait())
            own = [s for s in taken if s.service == _SELF_SERVICE]
            kinds = {s.name: set(s.tags) for s in own}
            if not {"flush", "flush.family", "flush.sink"} <= set(kinds) \
                    or kinds["flush"] != {"mode", "interval"} \
                    or not {"family", "dispatch_s", "transfer_s"} <= \
                    kinds["flush.family"] or kinds["flush.sink"] != {"sink"}:
                raise AssertionError(f"phase J4 {name}: self-spans "
                                     f"{kinds}")
            report[f"{name}_self_spans"] = len(own)
    finally:
        for server in (locals_ or []):
            server.shutdown()
        if proxy is not None:
            proxy.stop()
        gserver.shutdown()
        shutil.rmtree(workdir, ignore_errors=True)
    report["launches"] = _read_launches()
    for kernel in ("tdigest_flush", "hll_estimate", "llhist_apply"):
        if report["launches"][kernel] <= 0:
            raise AssertionError(f"phase J4: {kernel} was not launched")
    return report


def _phase_j5() -> dict:
    """J5: the cost of self-tracing at full width: phase A's corpus
    flushed by one server twice, trace_self_sample_rate 1 then 0.
    Each flush's total_s is reported; no bound is asserted."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    server = _j_server({}, _J_CAPS, [ChannelMetricSink()])
    lines, expect = _corpus(81, PHASE_A_KEYS)[:2]
    _zero_launches()
    server.start()
    flushes = []
    try:
        window = _pump_window(server)
        base = 0
        for rate in PHASE_J5_RATES:
            plane = server.trace_plane
            plane.sample_rate = rate
            plane.roll()  # the next interval's gate under this rate
            _send(server, server.listen_addresses[0], lines, base, window)
            base += len(lines)
            server.flush()
            got, _b = _collect(server.metric_sinks[0])
            _check_exact(got, expect)
            flushes.append({"sample_rate": rate,
                            "traced": "trace_id" in
                            server.telemetry.flushes.snapshot()[-1],
                            "total_s": server.last_flush_timings["total_s"]})
    finally:
        server.shutdown()
    if [f["traced"] for f in flushes] != [bool(r) for r in PHASE_J5_RATES]:
        raise AssertionError(f"phase J5: sampled {flushes}")
    return {"flushes": flushes, "launches": _read_launches()}


def _phase_j() -> dict:
    """Phase J: the overload plane (J1 admission, J2 the watermark
    ladder, J3 ingest chaos) and the self-trace plane (J4 one trace
    across the tiers, J5 its cost). Each part zeroes the launch counts
    just before it and reads them just after; the phase's launches are
    their sum."""
    t0 = time.perf_counter()
    parts = {}
    for name, run in (("J1", _phase_j1), ("J2", _phase_j2),
                      ("J3", _phase_j3), ("J4", _phase_j4),
                      ("J5", _phase_j5)):
        t_part = time.perf_counter()
        parts[name] = run()
        parts[name]["seconds"] = time.perf_counter() - t_part
        torch.cuda.empty_cache()
    launches = {k: sum(p["launches"][k] for p in parts.values())
                for k in parts["J1"]["launches"]}
    return {**parts, "launches": launches,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase S: the pull sources and the table lifecycle
# ---------------------------------------------------------------------------

PHASE_S1_KEYS = {"sum": 40_000, "gauge": 20_000, "ehist": 5_000}
PHASE_S1_POINTS = 1_000      # data points per OTLP request
PHASE_S1_BUCKETS = 32        # populated positive buckets per histogram
PHASE_S2_SERIES = {"counter": 20_000, "histogram": 1_000,
                   "summary": 1_000, "gauge": 5_000}
PHASE_S2_LE = ("0.005", "0.01", "0.025", "0.05", "0.1", "0.25", "0.5", "1",
               "2.5", "5", "10", "+Inf")
PHASE_S2_SCRAPES = 8
PHASE_S3_KEYS = {"counter": 40_000, "gauge": 20_000, "timer": 30_000,
                 "set": 10_000, "llhist": 5_000}
PHASE_S3_SAMPLES = 4         # per timer, set and `|l` key
PHASE_S3_INTERVALS = 6     # recycling from 5, flat tables over 4-6
PHASE_S4_KEYS = 3_000
PHASE_S4_CAP = 2_000


def _s_varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _s_ld(field: int, payload: bytes) -> bytes:
    return _s_varint((field << 3) | 2) + _s_varint(len(payload)) + payload


def _s_zz(v: int) -> int:
    return (v << 1) ^ (v >> 63)


_S_ATTR = _s_ld(1, b"pod") + _s_ld(2, _s_ld(1, b"smoke"))  # KeyValue


def _s_point_pb(kind: str, value) -> bytes:
    """One data point's protobuf: a number point (a gauge as_double, a
    sum as_int) or an exponential-histogram point (value = (scale, zero,
    (pos offset, counts), (neg offset, counts)))."""
    if kind == "gauge":
        return (_s_ld(7, _S_ATTR) + bytes([(4 << 3) | 1])
                + np.float64(value).tobytes())
    if kind == "sum":
        return (_s_ld(7, _S_ATTR) + bytes([(6 << 3) | 1])
                + np.int64(value).tobytes())
    scale, zero, pos, neg = value
    out = _s_ld(1, _S_ATTR) + _s_varint(6 << 3) + _s_varint(_s_zz(scale))
    out += bytes([(7 << 3) | 1]) + np.uint64(zero).tobytes()
    for field, (offset, counts) in ((8, pos), (9, neg)):
        out += _s_ld(field, _s_varint(1 << 3) + _s_varint(_s_zz(offset))
                     + _s_ld(2, b"".join(_s_varint(int(c))
                                         for c in counts)))
    return out


def _s_metric_pb(name: str, kind: str, value) -> bytes:
    point = _s_ld(1, _s_point_pb(kind, value))
    if kind == "gauge":
        return _s_ld(1, name.encode()) + _s_ld(5, point)
    if kind == "sum":  # cumulative, monotonic
        return (_s_ld(1, name.encode())
                + _s_ld(7, point + _s_varint(2 << 3) + _s_varint(2)
                        + _s_varint(3 << 3) + _s_varint(1)))
    return (_s_ld(1, name.encode())
            + _s_ld(10, point + _s_varint(2 << 3) + _s_varint(2)))


def _s_metric_json(name: str, kind: str, value) -> dict:
    attrs = [{"key": "pod", "value": {"stringValue": "smoke"}}]
    if kind == "gauge":
        return {"name": name, "gauge": {"dataPoints": [
            {"asDouble": float(value), "attributes": attrs}]}}
    if kind == "sum":
        return {"name": name, "sum": {
            "isMonotonic": True,
            "aggregationTemporality": "AGGREGATION_TEMPORALITY_CUMULATIVE",
            "dataPoints": [{"asInt": str(int(value)), "attributes": attrs}]}}
    scale, zero, pos, neg = value
    return {"name": name, "exponentialHistogram": {
        "aggregationTemporality": 2, "dataPoints": [{
            "attributes": attrs, "scale": scale, "zeroCount": str(zero),
            "positive": {"offset": pos[0],
                         "bucketCounts": [str(int(c)) for c in pos[1]]},
            "negative": {"offset": neg[0],
                         "bucketCounts": [str(int(c)) for c in neg[1]]}}]}}


def _s_downscale(offset: int, counts, d: int):
    """(offset, counts) at scale s re-bucketed onto scale s - d: index i
    covers (base^i, base^(i+1)], so its coarse index is i >> d."""
    new_off = offset >> d
    out = [0] * (((offset + len(counts) - 1) >> d) - new_off + 1)
    for i, c in enumerate(counts):
        out[((offset + i) >> d) - new_off] += int(c)
    return new_off, out


def _s1_corpus(seed: int):
    """Three pushes of cumulative OTLP series: per push the points to send
    (name, kind, value) and what its flush must hold: counter deltas (push
    1 primes and emits none; in push 3 a tenth of the sums reset), gauge
    values, and per histogram the (value, count) pairs its delta puts in
    the llhist family (midpoints taken after a downscale; push 1's prime
    lets the cumulative point stand)."""
    keys = PHASE_S1_KEYS
    rng = np.random.default_rng(seed)
    ns, ng, ne, nb = keys["sum"], keys["gauge"], keys["ehist"], \
        PHASE_S1_BUCKETS
    sums = np.empty((3, ns), np.int64)
    sums[0] = rng.integers(1_000, 1_000_000, ns)
    sums[1] = sums[0] + rng.integers(1, 5_000, ns)
    reset = np.arange(ns) % 10 == 0
    sums[2] = np.where(reset, rng.integers(0, 900, ns),
                       sums[1] + rng.integers(1, 5_000, ns))
    gauges = np.round(rng.normal(0, 100, (3, ng)), 3)
    pos_off = rng.integers(-80, 160 - nb, ne)
    neg_off = rng.integers(-40, 40, ne)
    pos = np.cumsum(np.stack([rng.integers(1, 20, (ne, nb)),
                              rng.integers(0, 6, (ne, nb)),
                              rng.integers(0, 6, (ne, nb))]), axis=0)
    neg = np.cumsum(np.stack([rng.integers(1, 9, (ne, 3)),
                              rng.integers(0, 3, (ne, 3)),
                              rng.integers(0, 3, (ne, 3))]), axis=0)
    zero = np.cumsum(rng.integers(0, 4, (3, ne)), axis=0)
    downscaled = np.arange(ne) % 2 == 0
    pushes = []
    for p in range(3):
        points = ([(f"so.c{k}", "sum", int(sums[p, k])) for k in range(ns)]
                  + [(f"so.g{k}", "gauge", float(gauges[p, k]))
                     for k in range(ng)])
        counters = {}
        if p:
            delta = np.where(sums[p] < sums[p - 1], np.maximum(sums[p], 0),
                             sums[p] - sums[p - 1])
            counters = {f"so.c{k}": float(delta[k]) for k in range(ns)}
        gauge_want = {f"so.g{k}": float(np.float32(gauges[p, k]))
                      for k in range(ng)}
        pairs_key, pairs_val, pairs_w = [], [], []
        for k in range(ne):
            cur_pos, cur_neg = pos[p, k].tolist(), neg[p, k].tolist()
            if p == 0:
                d_pos, d_neg, dz = cur_pos, cur_neg, int(zero[0, k])
            else:
                d_pos = (pos[p, k] - pos[p - 1, k]).tolist()
                d_neg = (neg[p, k] - neg[p - 1, k]).tolist()
                dz = int(zero[p, k] - zero[p - 1, k])
            scale, po, no = 3, int(pos_off[k]), int(neg_off[k])
            if p == 2 and downscaled[k]:
                scale = 2
                (po, cur_pos), (no, cur_neg) = (
                    _s_downscale(int(pos_off[k]), cur_pos, 1),
                    _s_downscale(int(neg_off[k]), cur_neg, 1))
                _po, d_pos = _s_downscale(int(pos_off[k]), d_pos, 1)
                _no, d_neg = _s_downscale(int(neg_off[k]), d_neg, 1)
            points.append((f"so.h{k}", "ehist",
                           (scale, int(zero[p, k]), (po, cur_pos),
                            (no, cur_neg))))
            # the source's expression for a bucket's midpoint, exactly
            base = 2.0 ** (2.0 ** -float(scale))
            if dz > 0:
                pairs_key.append(k)
                pairs_val.append(0.0)
                pairs_w.append(dz)
            for sign, offset, counts in ((1.0, po, d_pos),
                                         (-1.0, no, d_neg)):
                for i, cnt in enumerate(counts):
                    if cnt > 0:
                        pairs_key.append(k)
                        pairs_val.append(sign * base ** (offset + i + 0.5))
                        pairs_w.append(cnt)
        pushes.append({
            "points": points, "counters": counters, "gauges": gauge_want,
            "pairs": (np.asarray(pairs_key, np.int64),
                      np.asarray(pairs_val, np.float64),
                      np.asarray(pairs_w, np.int64))})
    return pushes


def _s1_requests(points) -> list:
    """The push as requests of PHASE_S1_POINTS points: every tenth JSON,
    every other gzip."""
    import gzip
    out = []
    for r, i in enumerate(range(0, len(points), PHASE_S1_POINTS)):
        chunk = points[i:i + PHASE_S1_POINTS]
        if r % 10 == 9:
            body = json.dumps({"resourceMetrics": [{"scopeMetrics": [{
                "metrics": [_s_metric_json(*pt) for pt in chunk]}]}]}
            ).encode()
            ctype = "application/json"
        else:
            body = _s_ld(1, _s_ld(2, b"".join(
                _s_ld(2, _s_metric_pb(*pt)) for pt in chunk)))
            ctype = "application/x-protobuf"
        encoding = ""
        if r % 2:
            body, encoding = gzip.compress(body, mtime=0), "gzip"
        out.append((body, ctype, encoding))
    return out


def _s_post(port: int, body: bytes, ctype: str, encoding: str) -> int:
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        headers = {"Content-Type": ctype}
        if encoding:
            headers["Content-Encoding"] = encoding
        conn.request("POST", "/v1/metrics", body, headers)
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


def _check_llhist_pairs(got: dict, buckets: dict, names, pairs) -> int:
    """Every series of the llhist keys `names` against llhist_ref over the
    (key index, value, count) pairs the smoke sent: `.count` and every
    `.bucket` line exactly, `.sum` against the bins' midpoint sum, each
    percentile against llhist_ref.quantiles. Returns series checked."""
    from veneur_tpu_torch.ops import llhist_ref as ref
    keys, vals, wts = pairs
    bins = ref.bin_index(vals)
    checked, bad = 0, []
    for lo in range(0, len(names), 1_000):
        hi = min(lo + 1_000, len(names))
        sel = (keys >= lo) & (keys < hi)
        dense = np.zeros((hi - lo, ref.BINS), np.int64)
        np.add.at(dense, (keys[sel] - lo, bins[sel]), wts[sel])
        srt = dense[:, ref.ORDER]
        cum = np.cumsum(srt, axis=1)
        sums = dense.astype(np.float64) @ ref.BIN_MID
        for j in range(hi - lo):
            name = names[lo + j]
            nz = np.flatnonzero(srt[j])
            want_b = {f"le:{_fmt_le(ref.UPPER_SORTED[s])}": float(cum[j, s])
                      for s in nz.tolist()}
            want_b["le:+Inf"] = float(cum[j, -1])
            if buckets.get(f"{name}.bucket") != want_b:
                bad.append((name, "bucket"))
            if got.get(f"{name}.count") != float(cum[j, -1]):
                bad.append((name, "count", got.get(f"{name}.count"),
                            float(cum[j, -1])))
            if not math.isclose(got.get(f"{name}.sum", math.nan), sums[j],
                                rel_tol=1e-12, abs_tol=1e-9):
                bad.append((name, "sum"))
            want_q = ref.quantiles(dense[j], PS)
            for i, p in enumerate(PS):
                q = got.get(f"{name}.{int(p * 100)}percentile", math.nan)
                if not math.isclose(q, want_q[i], rel_tol=LL_RTOL,
                                    abs_tol=1e-12):
                    bad.append((name, p, q, want_q[i]))
            checked += len(want_b) + 2 + len(PS)
    if bad:
        raise AssertionError(f"{len(bad)} llhist series wrong, e.g. "
                             f"{bad[:3]}")
    return checked


def _s1_inputs(seed: int):
    """Each push's expectations and its requests."""
    pushes = _s1_corpus(seed)
    return [(push, _s1_requests(push.pop("points"))) for push in pushes]


def _phase_s1(inputs=None) -> dict:
    """OTLP/HTTP at phase A's key widths: three pushes into a server with
    an otlp source, each flushed and checked. `inputs` are _s1_inputs'
    (built here when not given)."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    t_phase = time.perf_counter()
    inputs = _s1_inputs(31) if inputs is None else inputs
    server = _server({"statsd_listen_addresses": [],
                      "sources": [{"kind": "otlp", "name": "otlp", "config": {
                          "listen_address": "127.0.0.1:0"}}]},
                     {"counter_capacity": 65536, "gauge_capacity": 32768,
                      "llhist_capacity": 8192}, ChannelMetricSink())
    names = [f"so.h{k}" for k in range(PHASE_S1_KEYS["ehist"])]
    report = {"intervals": []}
    _zero_launches()
    server.start()
    try:
        src = server.sources[0]
        port = src.wait_started(30)
        seen = _read_launches()
        for p, (push, requests) in enumerate(inputs):
            t0 = time.perf_counter()
            statuses = [_s_post(port, *req) for req in requests]
            ingest_s = time.perf_counter() - t0
            if set(statuses) != {200}:
                raise AssertionError(f"phase S1 push {p + 1}: answers "
                                     f"{sorted(set(statuses))}")
            server.flush()
            now = _read_launches()
            got, buckets = _collect(server.metric_sinks[0])
            primed = [n for n in got if n.startswith("so.c")]
            if p == 0 and primed:
                raise AssertionError(f"phase S1: push 1 emitted counters "
                                     f"{primed[:3]}")
            _check_exact(got, push["counters"])
            _check_exact(got, push["gauges"])
            checked = len(push["counters"]) + len(push["gauges"]) + \
                _check_llhist_pairs(got, buckets, names, push["pairs"])
            report["intervals"].append({
                "requests": len(requests),
                "points": sum(PHASE_S1_KEYS.values()),
                "llhist_samples": int(push["pairs"][0].size),
                "ingest_s": ingest_s,
                "points_per_s": sum(PHASE_S1_KEYS.values()) / ingest_s,
                "flush": dict(server.last_flush_timings),
                "launches": {k: now[k] - seen[k] for k in now},
                "series_checked": checked})
            seen = now
    finally:
        server.shutdown()
    report["launches"] = _read_launches()
    counts = {k: v for k, v in
              server.telemetry.registry.snapshot()["counters"].items()
              if k.startswith("otlp.")}
    report["otlp_counts"] = counts
    if counts.get("otlp.parse_errors_total", 0) or \
            counts.get("otlp.gzip_rejected_total", 0):
        raise AssertionError(f"phase S1: otlp errors {counts}")
    stats = server.stats_snapshot()
    if stats["ingest_dispatch_errors"] or stats["unknown_rejected"]:
        raise AssertionError(f"phase S1: {stats}")
    if report["launches"]["llhist_apply"] <= 0:
        raise AssertionError("phase S1: llhist_apply was not launched")
    report["seconds"] = time.perf_counter() - t_phase
    return report


class _OmFake:
    """A 127.0.0.1 /metrics endpoint whose GET n serves every series at
    its value n: counters, histogram buckets and counts grow, gauges and
    summary quantiles move. `scale` divides PHASE_S2_SERIES."""

    def __init__(self, seed: int, scale: int = 1):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        rng = np.random.default_rng(seed)
        n = {k: v // scale for k, v in PHASE_S2_SERIES.items()}
        self.n = n
        self.c_base = rng.integers(0, 100_000, n["counter"])
        self.c_inc = rng.integers(1, 1_000, n["counter"])
        nle = len(PHASE_S2_LE)
        self.h_base = np.cumsum(rng.integers(0, 50, (n["histogram"], nle)),
                                axis=1)
        self.h_inc = np.cumsum(rng.integers(0, 20, (n["histogram"], nle)),
                               axis=1)
        self.q_base = rng.integers(0, 1_000, (n["summary"], 3))
        self.s_count = rng.integers(0, 1_000, n["summary"])
        self.g_base = rng.integers(-1_000, 1_000, n["gauge"])
        self.gets = 0
        self._lock = threading.Lock()
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802
                with fake._lock:
                    i = fake.gets
                    fake.gets += 1
                data = fake.text(i).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/metrics"

    def values(self, i: int) -> dict:
        """(name, tags) -> value as GET i serves it, by conversion kind."""
        counters, gauges = {}, {}
        for k, v in enumerate((self.c_base + i * self.c_inc).tolist()):
            counters[("om_reqs_total", (f"id:{k}",))] = float(v)
        hist = self.h_base + i * self.h_inc
        for h in range(self.n["histogram"]):
            for j, le in enumerate(PHASE_S2_LE):
                counters[("om_lat_bucket", (f"h:{h}", f"le:{le}"))] = \
                    float(hist[h, j])
            counters[("om_lat_count", (f"h:{h}",))] = float(hist[h, -1])
            gauges[("om_lat_sum", (f"h:{h}",))] = float(hist[h, -1]) * 0.5
        for s in range(self.n["summary"]):
            for j, q in enumerate(("0.5", "0.9", "0.99")):
                gauges[("om_rpc", (f"quantile:{q}", f"s:{s}"))] = \
                    float(self.q_base[s, j]) + 0.25 * i
            counters[("om_rpc_count", (f"s:{s}",))] = \
                float(self.s_count[s] + 3 * i)
        for g, v in enumerate(self.g_base.tolist()):
            gauges[("om_temp", (f"g:{g}",))] = v + 0.5 * i
        return {"counters": counters, "gauges": gauges}

    def text(self, i: int) -> str:
        vals = self.values(i)
        lines = ["# TYPE om_reqs_total counter", "# TYPE om_lat histogram",
                 "# TYPE om_rpc summary", "# TYPE om_temp gauge",
                 "# TYPE zz_other gauge"]
        for (name, tags), v in list(vals["counters"].items()) + \
                list(vals["gauges"].items()):
            labels = ",".join('%s="%s"' % tuple(t.split(":", 1))
                              for t in tags)
            lines.append(f"{name}{{{labels}}} {v!r}")
        for s in range(self.n["summary"]):  # denied by the denylist
            lines.append(f'om_rpc_sum{{s="{s}"}} {1.5 * i}')
        for z in range(100):  # outside the allowlist
            lines.append(f'zz_other{{z="{z}"}} {z}')
        return "\n".join(lines) + "\n"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _s2_check(fake, flushes, gets: int) -> int:
    """Over every flush: each counter's sum equals the last value served
    minus the first, each gauge's last value the last served; the
    filtered families are absent. Returns series checked."""
    first, last = fake.values(0), fake.values(gets - 1)
    sums, latest = {}, {}
    for tagged in flushes:
        for key, v in tagged.items():
            sums[key] = sums.get(key, 0.0) + v
            latest[key] = v
    bad = [(k, sums.get(k), v - first["counters"][k])
           for k, v in last["counters"].items()
           if sums.get(k) != v - first["counters"][k]]
    bad += [(k, latest.get(k), v) for k, v in last["gauges"].items()
            if latest.get(k) != v]
    stray = [k for k in sums if k[0] in ("om_rpc_sum", "zz_other")]
    if bad or stray:
        raise AssertionError(f"phase S2: {len(bad)} series wrong, e.g. "
                             f"{bad[:3]}; filtered families present "
                             f"{stray[:3]}")
    return len(last["counters"]) + len(last["gauges"])


def _phase_s2() -> dict:
    """OpenMetrics: a server scraping a ~46 000-line exposition every
    second, flushed every two scrapes and shut down after eight; then
    veneur-prometheus as a subprocess into a port server's UDP listener."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    t_phase = time.perf_counter()
    report = {}
    fake = _OmFake(41)
    try:
        sink = ChannelMetricSink()
        server = _server({
            "statsd_listen_addresses": [], "flush_on_shutdown": True,
            "sources": [{"kind": "openmetrics", "name": "om", "config": {
                "url": fake.url, "scrape_interval": "1s",
                "allowlist": "^om_", "denylist": "^om_rpc_sum$"}}]},
            {"counter_capacity": 65536, "gauge_capacity": 16384}, sink)
        _zero_launches()
        server.start()
        src = server.sources[0]
        flushes, flush_s = [], []
        try:
            for target in range(2, PHASE_S2_SCRAPES, 2):
                deadline = time.monotonic() + 120
                while src.scrapes + src.scrape_failures < target:
                    if time.monotonic() > deadline:
                        raise AssertionError("phase S2: the scrapes stalled")
                    time.sleep(0.02)
                server.flush()
                flush_s.append(server.last_flush_timings["total_s"])
                flushes.append(_collect_tagged(sink)[0])
            deadline = time.monotonic() + 120
            while src.scrapes + src.scrape_failures < PHASE_S2_SCRAPES:
                if time.monotonic() > deadline:
                    raise AssertionError("phase S2: the scrapes stalled")
                time.sleep(0.02)
        finally:
            server.shutdown()  # the source first, then the last flush
        last = {}
        for m in sink.drain():
            last[(m.name, tuple(m.tags))] = m.value
        flushes.append(last)
        stats = server.stats_snapshot()
        if stats["source_scrape_failures"]:
            raise AssertionError(f"phase S2: scrape failures {stats}")
        if stats["ingest_dispatch_errors"] or stats["unknown_rejected"]:
            raise AssertionError(f"phase S2: {stats}")
        checked = _s2_check(fake, flushes, fake.gets)
        report["S2"] = {"scrapes": stats["source_scrapes"],
                        "gets": fake.gets, "lines_per_scrape":
                        fake.text(0).count("\n"),
                        "flush_s": flush_s, "series_checked": checked,
                        "launches": _read_launches()}
    finally:
        fake.close()
    report["prometheus"] = _s2_prometheus()
    report["seconds"] = time.perf_counter() - t_phase
    report["launches"] = report["S2"]["launches"]
    return report


def _s2_prometheus() -> dict:
    """veneur-prometheus (`-scrapes 3`) as a subprocess against a fake
    with a tenth of the series, into a port server's UDP listener: every
    packet it reports sent arrives; the counters flush the deltas of
    scrapes 2 and 3, the gauges the last scrape's values."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    fake = _OmFake(43, scale=10)
    server = _server({"read_buffer_size_bytes": 32 << 20}, {},
                     ChannelMetricSink())
    server.start()
    try:
        port = server.listen_addresses[0][1]
        env = dict(os.environ, PYTHONPATH=ROOT)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "veneur_tpu_torch.cmd.veneur_prometheus",
             "-h", fake.url, "-s", f"127.0.0.1:{port}", "-i", "200ms",
             "-ignored-metrics", "^om_rpc_sum$,^zz_", "-scrapes", "3"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        run_s = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"veneur-prometheus exited "
                                 f"{out.returncode}: {out.stderr[-2000:]}")
        sent = json.loads(out.stdout.strip().splitlines()[-1])
        deadline = time.monotonic() + 60
        while server.stats_snapshot()["lines_received"] < sent["sent"]:
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"veneur-prometheus: sent {sent}, received "
                    f"{server.stats_snapshot()['lines_received']}")
            time.sleep(0.01)
        stats = server.stats_snapshot()
        if stats["lines_received"] != sent["sent"] or \
                sent["scrape_failures"] or stats["lines_rejected"]:
            raise AssertionError(f"veneur-prometheus: sent {sent}, "
                                 f"server {stats}")
        server.flush()
        tagged = _collect_tagged(server.metric_sinks[0])[0]
    finally:
        fake.close()
        server.shutdown()
    checked = _s2_check(fake, [tagged], fake.gets)
    return {"sent": sent, "run_s": run_s, "series_checked": checked}


def _s3_corpus(i: int):
    """Interval i's lines (shuffled): per family the key ids
    [i*N/2, i*N/2 + N), half of them new, half from interval i-1."""
    keys = PHASE_S3_KEYS
    rng = np.random.default_rng(500 + i)
    n_s = PHASE_S3_SAMPLES
    ids = {f: np.arange(i * n // 2, i * n // 2 + n) for f, n in keys.items()}
    lines, expect = [], {}
    cvals = rng.integers(1, 10_000, keys["counter"])
    for k, v in zip(ids["counter"].tolist(), cvals.tolist()):
        lines.append(f"sc.c{k}:{v}|c")
        expect[f"sc.c{k}"] = float(v)
    gtext = np.char.mod("%.3f", rng.normal(0, 100, keys["gauge"]))
    for k, v in zip(ids["gauge"].tolist(), gtext.tolist()):
        lines.append(f"sc.g{k}:{v}|g")
        expect[f"sc.g{k}"] = float(np.float32(float(v)))
    ttext = np.char.mod("%.3f", rng.gamma(2.0, 25.0, (keys["timer"], n_s)))
    for k, row in zip(ids["timer"].tolist(), ttext.tolist()):
        lines.extend(f"sc.t{k}:{v}|ms" for v in row)
    seed = 600 + i
    for k in ids["set"].tolist():
        lines.extend(f"sc.s{k}:u{seed}-{k}-{j}|s" for j in range(n_s))
    lvals = 10.0 ** rng.uniform(-3, 6, (keys["llhist"], n_s))
    ltext = np.char.mod("%.6g", lvals)
    for k, row in zip(ids["llhist"].tolist(), ltext.tolist()):
        lines.extend(f"sc.l{k}:{v}|l" for v in row)
    order = rng.permutation(len(lines))
    return {"lines": [lines[j] for j in order], "expect": expect,
            "ids": ids,
            "timers": np.sort(ttext.astype(np.float64).astype(np.float32),
                              axis=1),
            "set_ref": _set_reference(seed, keys["set"], n_s,
                                      ids=ids["set"].tolist()),
            "llhist": ltext.astype(np.float64)}


def _s_table_bytes(table) -> int:
    state = getattr(table, "state", None)
    tensors = (state.values() if isinstance(state, dict)
               else [state] if state is not None else [])
    return sum(t.numel() * t.element_size() for t in tensors)


def _phase_s3(corpora=None) -> dict:
    """Key churn with reclamation at phase A's key widths: six
    intervals on the pump with `idle_key_intervals: 2`, every series
    exact, the tables flat over the last three intervals. `corpora` are
    futures of _s3_corpus per interval (built here when not given)."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    t_phase = time.perf_counter()
    sink = ChannelMetricSink()
    server = _server({"count_unique_timeseries": True,
                      "ledger_strict": True},
                     {"counter_capacity": 65536, "gauge_capacity": 32768,
                      "histo_capacity": 32768, "set_capacity": 16384,
                      "llhist_capacity": 8192, "idle_key_intervals": 2,
                      "set_promote_samples": 2}, sink)
    report = {"intervals": []}
    keys = PHASE_S3_KEYS
    series = sum(keys.values())
    uniq_key = "flush.unique_timeseries_total|global_veneur:true"
    _zero_launches()
    server.start()
    try:
        addr = server.listen_addresses[0]
        rcvbuf = sum(s.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
                     for s in server._listeners[0]._socks)
        window = min(PUMP_WINDOW, rcvbuf // (2 * _QUEUED_BYTES_PER_LINE))
        base, seen, uniq_seen = 0, _read_launches(), 0.0
        tables = dict(server.store.tables())
        for i in range(PHASE_S3_INTERVALS):
            corpus = (_s3_corpus(i) if corpora is None
                      else corpora[i].result())
            free_before = {f: set(t._free_rows) for f, t in tables.items()}
            ingest_s = _send(server, addr, corpus["lines"], base, window)
            base += len(corpus["lines"])
            stats = server.stats_snapshot()
            if stats["lines_received"] != base or \
                    stats["ingest_dispatch_errors"]:
                raise AssertionError(f"phase S3 interval {i + 1}: {stats}")
            # keys of this interval on rows that an earlier key left
            on_recycled = {f: len(free_before[f] - set(t._free_rows))
                           for f, t in tables.items()}
            server.flush()  # strict ledger: raises on an imbalance
            now = _read_launches()
            got, buckets = _collect(sink)
            ids = corpus["ids"]
            _check_exact(got, corpus["expect"])
            checked = len(corpus["expect"]) + _check_timers(
                got, corpus["timers"], prefix="sc.t",
                ids=ids["timer"].tolist())
            _check_sets(got, corpus["set_ref"], PHASE_S3_SAMPLES,
                        prefix="sc.s", ids=ids["set"].tolist())
            # four samples a key: the percentiles are held to llhist_ref
            # only (a sample on a bin edge reads back the edge above in
            # float32, past the one-bin bound of well-filled keys)
            checked += keys["set"] + _check_llhists(
                got, buckets, "sc.l", corpus["llhist"],
                np.ones(keys["llhist"]), ids=ids["llhist"].tolist(),
                sample_quantile=False)
            uniq = server.telemetry.registry.snapshot()["counters"].get(
                uniq_key, 0.0)
            if uniq - uniq_seen != series:
                raise AssertionError(f"phase S3 interval {i + 1}: "
                                     f"unique_timeseries {uniq - uniq_seen}"
                                     f", sent {series}")
            uniq_seen = uniq
            live = sum(len(t.rows) for t in tables.values())
            intern = server._ingester.size()
            if intern > live:
                raise AssertionError(f"phase S3: intern table {intern} > "
                                     f"live rows {live}")
            rec = {
                "lines": len(corpus["lines"]), "ingest_s": ingest_s,
                "lines_per_s": len(corpus["lines"]) / ingest_s,
                "flush": dict(server.last_flush_timings),
                "launches": {k: now[k] - seen[k] for k in now},
                "series_checked": checked, "unique_timeseries": uniq,
                "on_recycled_rows": on_recycled,
                "tables": {f: {"capacity": t.capacity, "rows": len(t.meta),
                               "live": len(t.rows),
                               "free": len(t._free_rows),
                               "recycled_total": t.recycled_total}
                           for f, t in tables.items()},
                "intern_table_size": intern, "live_rows": live}
            if i in (0, 3, PHASE_S3_INTERVALS - 1):
                rec["device_bytes"] = {f: _s_table_bytes(t)
                                       for f, t in tables.items()}
            report["intervals"].append(rec)
            seen = now
    finally:
        server.shutdown()
    ivs = report["intervals"]
    recycled = sum(r["recycled_total"] for r in ivs[4]["tables"].values())
    if recycled <= 0:
        raise AssertionError("phase S3: no row recycled by interval 5")
    for rec in ivs[4:]:
        short = [f for f in ("counter", "gauge", "histogram", "set",
                             "llhist") if rec["on_recycled_rows"][f] <= 0]
        if short:
            raise AssertionError(f"phase S3: no new key on a recycled row "
                                 f"of {short}")
    flat = [{f: (t["capacity"], t["rows"]) for f, t in r["tables"].items()}
            for r in ivs[-3:]]
    if not flat[0] == flat[1] == flat[2]:
        raise AssertionError(f"phase S3: tables grew in the last three "
                             f"intervals: {flat}")
    report["launches"] = _read_launches()
    for kernel in ("tdigest_flush", "hll_estimate", "llhist_apply"):
        if report["launches"][kernel] <= 0:
            raise AssertionError(f"phase S3: {kernel} was not launched")
    report["seconds"] = time.perf_counter() - t_phase
    return report


def _phase_s4() -> dict:
    """The row cap: 3 000 counter and 3 000 `|l` keys into a server
    capped at 2 000 rows a family; 2 000 of each flush, exactly, and the
    other keys' samples are counted dropped and rejected."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    t_phase = time.perf_counter()
    n, cap = PHASE_S4_KEYS, PHASE_S4_CAP
    rng = np.random.default_rng(700)
    cvals = rng.integers(1, 1_000, n)
    lvals = np.char.mod("%.6g", 10.0 ** rng.uniform(-3, 6, n))
    lines = [f"cap.c{k}:{cvals[k]}|c" for k in range(n)] + \
        [f"cap.l{k}:{lvals[k]}|l" for k in range(n)]
    lines = [lines[j] for j in rng.permutation(len(lines))]
    sink = ChannelMetricSink()
    server = _server({"ledger_strict": True},
                     {"max_rows_per_family": cap}, sink)
    _zero_launches()
    server.start()
    try:
        ingest_s = _send(server, server.listen_addresses[0], lines, 0,
                         PUMP_WINDOW)
        server.flush()
        got, buckets = _collect(sink)
        stats = server.stats_snapshot()
        dropped = server.telemetry.registry.snapshot()["counters"].get(
            "intern.keys_dropped_total", 0.0)
        rejected = dict(server.ledger._history[-1]["stages"].get(
            "agg.rejected", {}))
    finally:
        server.shutdown()
    counters = {k: v for k, v in got.items() if k.startswith("cap.c")}
    if len(counters) != cap:
        raise AssertionError(f"phase S4: {len(counters)} counters flushed")
    wrong = [k for k, v in counters.items()
             if v != float(cvals[int(k[len("cap.c"):])])]
    ll_ids = sorted(int(k[len("cap.l"):-len(".count")]) for k in got
                    if k.startswith("cap.l") and k.endswith(".count"))
    if len(ll_ids) != cap or wrong:
        raise AssertionError(f"phase S4: {len(ll_ids)} llhists flushed, "
                             f"{len(wrong)} counters wrong")
    checked = cap + _check_llhists(
        got, buckets, "cap.l",
        lvals[ll_ids].astype(np.float64)[:, None], np.ones(cap), ids=ll_ids,
        sample_quantile=False)
    want = {"counter": float(n - cap), "llhist": float(n - cap)}
    if stats["keys_dropped"] != 2 * (n - cap) or \
            dropped != 2 * (n - cap) or rejected != want:
        raise AssertionError(f"phase S4: dropped {stats['keys_dropped']} / "
                             f"{dropped}, ledger agg.rejected {rejected}")
    launches = _read_launches()
    if launches["llhist_apply"] <= 0:
        raise AssertionError("phase S4: llhist_apply was not launched")
    return {"lines": len(lines), "ingest_s": ingest_s,
            "series_checked": checked, "keys_dropped": stats["keys_dropped"],
            "agg_rejected": rejected, "launches": launches,
            "seconds": time.perf_counter() - t_phase}


def _phase_s() -> dict:
    """S1-S4. Two worker processes (spawned: the card is never forked)
    build S1's requests and S3's corpora while the servers run."""
    import concurrent.futures
    import multiprocessing
    t0 = time.perf_counter()
    rep = {}
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    try:
        s1_inputs = pool.submit(_s1_inputs, 31)
        s3_corpora = [pool.submit(_s3_corpus, i)
                      for i in range(PHASE_S3_INTERVALS)]
        for part, run in (("S1", lambda: _phase_s1(s1_inputs.result())),
                          ("S2", _phase_s2),
                          ("S3", lambda: _phase_s3(s3_corpora)),
                          ("S4", _phase_s4)):
            rep[part] = run()
            torch.cuda.empty_cache()
            print(f"phase {part} passed in {rep[part]['seconds']:.1f} s",
                  flush=True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    rep["launches"] = {k: sum(rep[p]["launches"][k]
                              for p in ("S1", "S2", "S3", "S4"))
                       for k in rep["S1"]["launches"]}
    rep["seconds"] = time.perf_counter() - t0
    return rep


# -- phase O: the overlapped flush and the cardinality rung -------------

PHASE_O_LL_KEYS = 5_000          # the D/F corpus: A's keys + `|l` x 32
PHASE_O2_STORM = 60_000          # new `pod:` values of storm.lat a interval
PHASE_O2_LIMITS = {"cardinality_soft_limit": 2_000,
                   "cardinality_hard_limit": 10_000,
                   "cardinality_degraded_keep": 0.1}
PHASE_O2_LL_CAPACITY = 4_096     # interval 2's mints double the table
PHASE_O2_BATCH = 1_024           # so an apply follows the resize in-interval


def _o_latency(report: dict) -> dict:
    """The /debug/latency numbers phase O prints: the dogstatsd sample
    age and each queue's dwell."""
    age = report["sample_age"].get("dogstatsd", {})
    return {"sample_age": {k: age.get(k) for k in ("count", "p50", "p99",
                                                    "max")},
            "queues": {name: {"depth": q.get("depth"),
                              **{k: q.get("dwell", {}).get(k)
                                 for k in ("count", "p50", "p99")}}
                       for name, q in report["queues"].items()}}


def _phase_o1() -> dict:
    """The overlapped flush at full width: phase D/F's corpus (A's keys
    plus 5 000 `|l` keys x 32) on the pump with `flush_async` and the
    latency observatory. Tick 1 swaps interval 1 and submits its readout;
    interval 2's lines are sent while it runs; tick 2 delivers interval
    1 and submits interval 2; shutdown() without flush_on_shutdown
    delivers interval 2 in its deliver-only pass. Both intervals are
    checked series by series, every ledger interval is strict."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    corpora = [_corpus(seed, PHASE_A_KEYS, PHASE_O_LL_KEYS) + (
        _set_reference(seed, PHASE_A_KEYS["set"],
                       PHASE_A_KEYS["set_members"]),) for seed in (31, 32)]
    server = _server({"flush_async": True, "latency_observatory": True,
                      "ledger_strict": True, "flush_on_shutdown": False,
                      "http_address": "127.0.0.1:0"},
                     {"counter_capacity": 65536, "gauge_capacity": 32768,
                      "histo_capacity": 32768, "set_capacity": 16384,
                      "llhist_capacity": 8192}, ChannelMetricSink())
    sink = server.metric_sinks[0]
    check = _check_a_or_c(PHASE_A_KEYS)
    swapped_rows = (sum(PHASE_A_KEYS[k] for k in ("counter", "gauge",
                                                  "timer", "set"))
                    + PHASE_O_LL_KEYS)
    report = {"intervals": []}
    _zero_launches()
    server.start()
    try:
        addr = server.listen_addresses[0]
        window = _pump_window(server)
        n1 = len(corpora[0][0])
        ingest1 = _send(server, addr, corpora[0][0], 0, window)
        tick1_start = time.time()
        server.flush()  # tick 1: swap + submit, nothing delivered
        tick1 = dict(server.last_flush_timings)
        head = server._inflight_flushes[0]
        stock = server.ledger._history[-1]["stocks"]["closing"][
            "flush_inflight_snapshot"]
        if not (server._inflight_rows == head["swap"]["rows"] == stock
                == swapped_rows):
            raise AssertionError(
                f"phase O1: in-flight rows {server._inflight_rows}, swap "
                f"{head['swap']['rows']}, ledger stock {stock}, want "
                f"{swapped_rows}")
        if sink.drain():
            raise AssertionError("phase O1: tick 1 delivered metrics")
        # interval 2's lines while readout 1 runs on the executor
        ingest2 = _send(server, addr, corpora[1][0], n1, window)
        readout1_done_by_send_end = head["pending"].done()
        tick2_start = time.time()
        server.flush()  # tick 2: delivers interval 1, submits interval 2
        tick2 = dict(server.last_flush_timings)
        round2 = server.telemetry.flushes.snapshot()[-1]
        got, buckets = _collect(sink)
        rec1 = check(corpora[0], got, buckets)
        if not (round2.get("async") and round2.get("delivered_flush") == 1
                and head["readout_start_unix"] < tick2_start):
            raise AssertionError(f"phase O1: tick 2 round {round2}")
        status, body = _http(server.http_api.address, "/debug/latency")
        if status != 200:
            raise AssertionError(f"phase O1: /debug/latency {status}")
        latency_tick2 = _o_latency(json.loads(body))
        stats = server.stats_snapshot()
        if stats["lines_received"] != n1 + len(corpora[1][0]):
            raise AssertionError(f"phase O1: lines {stats}")
    except BaseException:
        # a failed check ends the phase: no deliver-only pass
        server.config.flush_async = False
        server.shutdown()
        raise
    server.shutdown()  # the deliver-only pass: interval 2
    got, buckets = _collect(sink)
    rec2 = check(corpora[1], got, buckets)
    tick3 = dict(server.last_flush_timings)
    report["launches"] = _read_launches()
    readout_s = sum(tick2.get(k, 0.0) for k in ("dispatch_s",
                                                "device_sync_s",
                                                "assembly_s"))
    report.update(
        swapped_rows=swapped_rows,
        intervals=[{"lines": n1, "ingest_s": ingest1,
                    "lines_per_s": n1 / ingest1, **rec1},
                   {"lines": len(corpora[1][0]), "ingest_s": ingest2,
                    "lines_per_s": len(corpora[1][0]) / ingest2, **rec2}],
        ticks=[{k: tick[k] for k in ("swap_s", "join_s", "dispatch_s",
                                     "device_sync_s", "assembly_s",
                                     "sinks_s", "total_s") if k in tick}
               for tick in (tick1, tick2, tick3)],
        critical_path_s=round2["phases"]["critical_path_s"],
        readout1_s=readout_s,
        readout1_start_after_tick1_s=head["readout_start_unix"]
        - tick1_start,
        readout1_done_by_send_end=readout1_done_by_send_end,
        latency_tick2=latency_tick2,
        latency=_o_latency(server.latency.report()),
        readout_failed=server.stats_snapshot()["readout_failed"],
        ledger_intervals=len(server.ledger._history))
    if report["readout_failed"]:
        raise AssertionError("phase O1: a readout failed")
    if report["latency"]["sample_age"]["count"] != 4:
        raise AssertionError(f"phase O1: sample ages {report['latency']}")
    for kernel in ("tdigest_flush", "hll_estimate", "llhist_apply"):
        if report["launches"][kernel] <= 0:
            raise AssertionError(f"phase O1: {kernel} was not launched")
    return report


def _o2_lines(seed: int, interval: int, resend=None):
    """Phase O2's lines of one interval (shuffled): phase A's counter and
    timer keys, one sample each; storm.lat (`|l`) with PHASE_O2_STORM
    new `pod:` values; in interval 2 also one new sample for each of
    interval 1's admitted pods (`resend`). Returns the lines, the
    counters' expected values, the timers' samples and each pod's
    value."""
    rng = np.random.default_rng(seed)
    lines, expect = [], {}
    cvals = rng.integers(1, 1000, PHASE_A_KEYS["counter"])
    for k, v in enumerate(cvals.tolist()):
        lines.append(f"smoke.c{k}:{v}|c")
        expect[f"smoke.c{k}"] = float(v)
    ttext = np.char.mod("%.3f", rng.gamma(2.0, 25.0,
                                          PHASE_A_KEYS["timer"]))
    lines.extend(f"smoke.t{k}:{v}|ms" for k, v in enumerate(ttext))
    timers = ttext.astype(np.float64).astype(np.float32)[:, None]
    pods = list(range(interval * PHASE_O2_STORM,
                      (interval + 1) * PHASE_O2_STORM)) + list(resend or ())
    text = np.char.mod("%.6g", 10.0 ** rng.uniform(-3, 6, len(pods)))
    lines.extend(f"storm.lat:{v}|l|#pod:p{p}" for p, v in zip(pods, text))
    values = dict(zip(pods, text.astype(np.float64).tolist()))
    order = rng.permutation(len(lines))
    return [lines[i] for i in order], expect, timers, values


def _o2_collect(sink) -> tuple:
    """One flush: the untagged series by name, and storm.lat's series by
    pod ({"count", "sum", "le:<bound>": bucket, ...})."""
    got, storm = {}, {}
    for m in sink.wait_flush(timeout=600):
        pod = next((t[4:] for t in m.tags if t.startswith("pod:")), None)
        if pod is None:
            got[m.name] = m.value
            continue
        entry = storm.setdefault(int(pod[1:]), {})
        if m.name.endswith(".bucket"):
            entry[next(t for t in m.tags if t.startswith("le:"))] = m.value
        else:
            entry[m.name[len("storm.lat."):]] = m.value
    return got, storm


def _o2_check_storm(storm: dict, values: dict) -> int:
    """Every admitted storm series holds exactly its one sample: `.count`
    1, one bucket at its bin's upper bound and `+Inf`, each 1, `.sum` the
    bin's midpoint and every percentile llhist_ref's."""
    from veneur_tpu_torch.ops import llhist_ref as ref
    pods = sorted(storm)
    vals = np.array([values[p] for p in pods])
    rank = np.empty(ref.BINS, np.int64)
    rank[ref.ORDER] = np.arange(ref.BINS)
    bins = ref.bin_index(vals)
    slots = rank[bins]
    bad = []
    for p, b, s in zip(pods, bins.tolist(), slots.tolist()):
        entry = storm[p]
        want_b = {f"le:{_fmt_le(ref.UPPER_SORTED[s])}": 1.0, "le:+Inf": 1.0}
        got_b = {k: v for k, v in entry.items() if k.startswith("le:")}
        dense = np.zeros(ref.BINS, np.int64)
        dense[b] = 1
        want_q = ref.quantiles(dense, PS)
        if (got_b != want_b or entry.get("count") != 1.0
                or not math.isclose(entry.get("sum", math.nan),
                                    ref.MID_SORTED[s], rel_tol=1e-12)
                or not all(math.isclose(
                    entry.get(f"{int(q * 100)}percentile", math.nan), w,
                    rel_tol=LL_RTOL) for q, w in zip(PS, want_q))):
            bad.append((p, entry))
    if bad:
        raise AssertionError(f"phase O2: {len(bad)} storm series wrong, "
                             f"e.g. {bad[:2]}")
    return len(pods) * (3 + len(PS))


def _o2_server(prewarm: bool, tpu_extra: dict):
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    return _server({**PHASE_O2_LIMITS, "prewarm_ladder": prewarm,
                    "ledger_strict": True, "http_address": "127.0.0.1:0"},
                   {"batch_cap": PHASE_O2_BATCH,
                    "llhist_capacity": PHASE_O2_LL_CAPACITY, **tpu_extra},
                   ChannelMetricSink())


def _o2_run() -> dict:
    """O2's prewarmed server through two storm intervals, with phase A's
    counter and timer keys, and every check."""
    server = _o2_server(True, {"counter_capacity": 65536,
                               "histo_capacity": 32768})
    sink = server.metric_sinks[0]
    llh = server.store.llhists
    soft = PHASE_O2_LIMITS["cardinality_soft_limit"]
    hard = PHASE_O2_LIMITS["cardinality_hard_limit"]
    keep = soft + (hard - soft) // round(
        1 / PHASE_O2_LIMITS["cardinality_degraded_keep"])
    out = {"intervals": []}
    _zero_launches()
    server.start()
    try:
        t0 = time.perf_counter()
        while 2 * PHASE_O2_LL_CAPACITY not in llh._prewarmed_caps:
            if time.perf_counter() - t0 > 300:
                raise AssertionError("phase O2: the prewarmer did not "
                                     "reach the llhist rung")
            time.sleep(0.05)
        out["prewarm_wait_s"] = time.perf_counter() - t0
        addr = server.listen_addresses[0]
        window = _pump_window(server)
        base = 0
        admitted = []
        for interval in range(2):
            lines, expect, timers, values = _o2_lines(
                41 + interval, interval, resend=admitted)
            ingest_s = _send(server, addr, lines, base, window)
            base += len(lines)
            server.flush()
            timings = dict(server.last_flush_timings)
            got, storm = _o2_collect(sink)
            rec = {"lines": len(lines), "ingest_s": ingest_s,
                   "lines_per_s": len(lines) / ingest_s,
                   "storm_series": len(storm),
                   "flush_s": timings["total_s"],
                   "flush": {k: timings[k] for k in (
                       "swap_s", "dispatch_s", "device_sync_s",
                       "assembly_s", "sinks_s") if k in timings}}
            new = sorted(p for p in storm if p >= interval * PHASE_O2_STORM)
            if len(new) != keep or (interval and sorted(
                    p for p in storm if p < PHASE_O2_STORM) != admitted):
                raise AssertionError(
                    f"phase O2 interval {interval + 1}: {len(new)} new "
                    f"storm series (want {keep}); resent "
                    f"{len(storm) - len(new)} of {len(admitted)}")
            stages = server.ledger._history[-1]["stages"]
            shed = {k: v for k, v in stages.get("ingress.shed", {}).items()
                    if v}
            want_shed = {"llhist|cardinality": PHASE_O2_STORM - hard,
                         "llhist|cardinality_degraded": hard - keep}
            kept = stages["agg.applied"].get("llhist", 0)
            if (shed != want_shed
                    or stages.get("agg.rejected") != {
                        "llhist": PHASE_O2_STORM - keep}
                    or kept != keep + len(admitted)
                    or kept - len(admitted) + sum(shed.values())
                    != PHASE_O2_STORM):
                raise AssertionError(
                    f"phase O2 interval {interval + 1}: shed {shed}, "
                    f"stages {stages}")
            rec.update(shed=shed, kept=kept)
            _check_exact(got, expect)
            checked = len(expect) + _check_timers(got, timers)
            rec["series_checked"] = checked + _o2_check_storm(storm, values)
            pod = server.cardinality.tag_report("storm.lat")[
                "tag_keys"]["pod"]
            hll_min = server.config.cardinality_hll_min_mints
            truth = (interval + 1) * PHASE_O2_STORM - (hll_min - 1)
            rec["pod_estimate"] = pod
            rec["pod_truth"] = truth
            if abs(pod - truth) > 0.03 * truth:
                raise AssertionError(f"phase O2: pod estimate {pod} "
                                     f"against {truth}")
            status, body = _http(server.http_api.address,
                                 "/debug/cardinality?top=5")
            top = json.loads(body)["top"] if status == 200 else []
            if not top or top[0]["name"] != "storm.lat":
                raise AssertionError(f"phase O2: /debug/cardinality "
                                     f"{status} {top[:2]}")
            rec["top"] = [(t["name"], t["live_rows"],
                           t.get("mints_last_interval")) for t in top[:3]]
            if "storm.lat" not in server.trace_plane._watch:
                raise AssertionError("phase O2: storm.lat is not on the "
                                     "exemplar watch list")
            out["intervals"].append(rec)
            admitted = sorted(new)
        shed_total = server.overload.shed_snapshot()
        if shed_total.get("llhist|cardinality") != \
                2 * (PHASE_O2_STORM - hard):
            raise AssertionError(f"phase O2: shed table {shed_total}")
        out.update(
            resize_total=llh.resize_total, capacity=llh.capacity,
            resize_s=llh.resize_last_seconds,
            first_apply_s=llh.first_apply_last_seconds,
            first_apply_events=server.telemetry.events.snapshot(
                kind="columnstore_first_apply"),
            prewarm=server.prewarmer.telemetry_rows())
    finally:
        server.shutdown()
    out["launches"] = _read_launches()
    if llh.resize_total != 1 or llh.capacity != 2 * PHASE_O2_LL_CAPACITY:
        raise AssertionError(f"phase O2: llhist resized "
                             f"{llh.resize_total} times to {llh.capacity}")
    return out


def _o2_cold_resize() -> dict:
    """O2's server without the prewarmer, doubled the same way: one
    interval of 1.5 x PHASE_O2_LL_CAPACITY `|l` names of one key each
    (no budget is hit), so the llhist table resizes from 4 096 to 8 192
    rows and an apply follows in the interval; every `.count` exact."""
    server = _o2_server(False, {})
    sink = server.metric_sinks[0]
    llh = server.store.llhists
    n = PHASE_O2_LL_CAPACITY + PHASE_O2_LL_CAPACITY // 2
    lines = [f"cold.l{k}:{1.5 + k % 97}|l" for k in range(n)]
    _zero_launches()
    server.start()
    try:
        ingest_s = _send(server, server.listen_addresses[0], lines, 0,
                         _pump_window(server))
        server.flush()
        got, _buckets = _collect(sink)
        wrong = [k for k in range(n) if got.get(f"cold.l{k}.count") != 1.0]
        if wrong:
            raise AssertionError(f"phase O2 cold: {len(wrong)} `|l` counts "
                                 f"wrong, e.g. cold.l{wrong[0]}")
        out = {"lines": n, "lines_per_s": n / ingest_s,
               "resize_total": llh.resize_total, "capacity": llh.capacity,
               "resize_s": llh.resize_last_seconds,
               "first_apply_s": llh.first_apply_last_seconds,
               "first_apply_events": server.telemetry.events.snapshot(
                   kind="columnstore_first_apply")}
    finally:
        server.shutdown()
    out["launches"] = _read_launches()
    if llh.resize_total != 1 or llh.capacity != 2 * PHASE_O2_LL_CAPACITY \
            or not out["first_apply_events"]:
        raise AssertionError(f"phase O2 cold: llhist resized "
                             f"{llh.resize_total} times to {llh.capacity}")
    return out


def _o2_gate_cost(calls: int = 200_000) -> dict:
    """The mint gate alone on the host: admit_mint + note_mint for
    `calls` new keys of one name under O2's limits, and of `calls`
    names of one key each (no budget hit)."""
    from veneur_tpu_torch.core.cardinality import CardinalityAccountant
    out = {}
    for label, names in (("one_name", ["storm.lat"] * calls),
                         ("distinct_names", [f"n{i}" for i in
                                             range(calls)])):
        acc = CardinalityAccountant(
            soft_limit=PHASE_O2_LIMITS["cardinality_soft_limit"],
            hard_limit=PHASE_O2_LIMITS["cardinality_hard_limit"],
            degraded_keep=PHASE_O2_LIMITS["cardinality_degraded_keep"],
            on_shed=lambda *a: None)
        tags = [[f"pod:p{i}"] for i in range(calls)]
        t0 = time.perf_counter()
        for name, tg in zip(names, tags):
            if acc.admit_mint("llhist", name, tg):
                acc.note_mint("llhist", name)
        out[f"{label}_us"] = (time.perf_counter() - t0) / calls * 1e6
    return out


def _phase_o2() -> dict:
    """The cardinality rung and the prewarmer: a server with
    cardinality_soft_limit 2 000, hard 10 000, degraded keep 0.1 takes
    phase A's counter and timer keys (one sample each, one key a name)
    and a storm of 60 000 new `pod:` values of storm.lat (`|l`) in each
    of two intervals, interval 2 re-sending interval 1's admitted pods.
    Each interval admits 2 000 + 8 000 / 10 = 2 800 mints and sheds
    7 200 `cardinality_degraded` and 50 000 `cardinality`, exactly;
    every admitted series is exact. With prewarm_ladder and
    llhist_capacity 4 096 interval 2 doubles the llhist table; a second
    server, prewarm off, doubles its own (_o2_cold_resize), for the
    first apply after the resize without the prewarm."""
    t0 = time.perf_counter()
    prewarmed = _o2_run()
    t1 = time.perf_counter()
    cold = _o2_cold_resize()
    t2 = time.perf_counter()
    launches = {k: prewarmed["launches"][k] + cold["launches"][k]
                for k in prewarmed["launches"]}
    for kernel in ("tdigest_flush", "llhist_apply"):
        if launches[kernel] <= 0:
            raise AssertionError(f"phase O2: {kernel} was not launched")
    return {"prewarmed": prewarmed, "cold": cold, "launches": launches,
            "gate": _o2_gate_cost(), "prewarmed_s": t1 - t0,
            "cold_s": t2 - t1}


def _phase_o() -> dict:
    t0 = time.perf_counter()
    o1 = _phase_o1()
    o1["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    o2 = _phase_o2()
    o2["seconds"] = time.perf_counter() - t0
    return {"O1": o1, "O2": o2,
            "launches": {k: o1["launches"][k] + o2["launches"][k]
                         for k in o1["launches"]}}


PHASE_P_LL_KEYS = PHASE_O_LL_KEYS  # D's local corpus: A's keys + `|l` x 32
PHASE_P_SEEDS = (61, 62)
PHASE_P_TAIL = 20                  # interval 2's last 1/20th: in the trace
PHASE_P_TRACE_S = 6.0              # the device capture spanning flush 2
PHASE_P3_RATE = 5_000              # counter lines/s through the handoff
PHASE_P3_PER_DGRAM = 50
PHASE_P3_PROBE_S = 0.02            # TCP connect probes of the HTTP port


def _p_nbytes(tree) -> int:
    """Bytes of a table generation, walked here: numel x element size of
    every tensor in it."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_p_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


class _PLedger:
    """Holds the device observatory's HBM ledger to the tensors: wraps each
    device table's swap_out, readout, recycle and prewarm_rung, and the
    llhist table's _grow, and after every call the ledger's total must
    equal the bytes of every table's live and spare tensors plus the
    generations swapped out and not yet recycled (and, mid-prewarm, the
    rung's throwaway state), and stay within torch.cuda.memory_allocated().
    `hooks[(family, name)]` runs before the wrapped call."""

    def __init__(self, server):
        self.obs = server.deviceobs
        self.tables = [(f, t) for f, t in server.store.tables()
                       if f != "status"]
        self.inflight = {}
        self.hooks = {}
        self.checks = {}
        self.prewarm_mid = None
        for family, table in self.tables:
            names = ["swap_out", "readout", "recycle", "prewarm_rung"]
            if family == "llhist":
                names += ["_grow", "_prewarm_apply"]
            for name in names:
                setattr(table, name, self._wrap(family, table, name))

    def _wrap(self, family, table, name):
        real = getattr(table, name)

        def call(*args, **kwargs):
            hook = self.hooks.get((family, name))
            if hook is not None:
                hook()
            if name == "_prewarm_apply":
                self.check(f"{family}.prewarm (mid)", extra=args[0])
                self.prewarm_mid = self.obs.ledger()["by_family"][family][
                    "prewarm"]
            out = real(*args, **kwargs)
            if name == "swap_out" and "state" in out:
                self.inflight[id(out)] = out["state"]
            elif name == "recycle":
                self.inflight.pop(id(args[0]), None)
            if name != "_prewarm_apply":
                self.check(f"{family}.{name.strip('_')}")
            return out
        return call

    def walk(self, extra=None) -> int:
        return (sum(_p_nbytes(t.state) + _p_nbytes(t._spare)
                    for _f, t in self.tables)
                + sum(_p_nbytes(s) for s in self.inflight.values())
                + _p_nbytes(extra))

    def check(self, step: str, extra=None) -> None:
        total, walked = self.obs.total_bytes(), self.walk(extra)
        allocated = torch.cuda.memory_allocated()
        if total != walked or total > allocated:
            raise AssertionError(
                f"phase P1 after {step}: ledger {total} bytes, tensors "
                f"{walked}, allocated {allocated}")
        self.checks[step] = self.checks.get(step, 0) + 1

    def snapshot(self, label: str) -> dict:
        led = self.obs.ledger()
        return {"at": label, "total": led["total_bytes"],
                "by_family": {f: {s: n for s, n in st.items() if n}
                              for f, st in led["by_family"].items()},
                "allocated": torch.cuda.memory_allocated(),
                "reserved": torch.cuda.memory_reserved()}


def _p_hook_cost(table, calls: int = 20_000) -> dict:
    """Host microseconds of one kernel-registry hook (the table's `_noted`
    around an empty call) with an observatory attached, less the same
    call without one, and of one ledger retag; measured on a throwaway
    observatory, so the server's registry is left as it was."""
    from veneur_tpu_torch.core.deviceobs import DeviceObservatory

    def per_call_us(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) / calls * 1e6
    attached = table._deviceobs
    scratch = DeviceObservatory()
    tok = scratch.note_generation("counter", "live", table.state)
    try:
        table._deviceobs = None
        bare = per_call_us(lambda: table._noted("apply", lambda: None))
        table._deviceobs = scratch
        hooked = per_call_us(lambda: table._noted("apply", lambda: None))
    finally:
        table._deviceobs = attached
    retag = per_call_us(lambda: scratch.retag(tok, "live"))
    return {"hook_us": hooked - bare, "bare_us": bare, "retag_us": retag}


def _p_pprof_strings(body: bytes) -> list:
    """The string table of a gzipped pprof profile (field 6); raises on a
    malformed one."""
    import gzip
    from veneur_tpu_torch.util.protowire import read_fields
    if body[:2] != b"\x1f\x8b":
        raise AssertionError("phase P2: the pprof body is not gzipped")
    fields: dict = {}
    for num, _wt, value in read_fields(gzip.decompress(body)):
        fields.setdefault(num, []).append(value)
    for num in (1, 2, 4, 5, 6, 12):
        if num not in fields:
            raise AssertionError(f"phase P2: pprof field {num} missing")
    return [s.decode("utf-8", "replace") for s in fields[6]]


def _p_trace_numbers(trace: dict, window) -> dict:
    """From a torch.profiler Chrome trace: each path kernel's events and
    summed device time, and over the flush's wall-clock window (unix
    seconds, placed on the trace's clock by its baseTimeNanoseconds) the
    device busy share (the union of kernel, copy and set intervals over
    the window) and the top five device operations by time."""
    events = trace.get("traceEvents", ())
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    base_us = trace["baseTimeNanoseconds"] / 1e3
    lo, hi = (t * 1e6 - base_us for t in window)
    spans = [e for e in events if e.get("cat") == "Trace"
             and str(e.get("name", "")).startswith("PyTorch Profiler")]
    captured = (min(e["ts"] for e in spans),
                max(e["ts"] + e["dur"] for e in spans)) if spans else None
    if captured is None or lo < captured[0] or hi > captured[1]:
        raise AssertionError(f"phase P2: the flush window {lo}..{hi} us "
                             f"is not inside the capture {captured}")
    out = {"device_events": len(device), "kernels": {}}
    for kernel in ("tdigest_flush_kernel", "hll_estimate_kernel",
                   "llhist_apply_kernel"):
        evs = [e for e in device if kernel in e["name"]]
        out["kernels"][kernel] = {"events": len(evs), "device_ms": sum(
            e["dur"] for e in evs) / 1e3}
    inside = [e for e in device if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy, end = 0.0, lo
    for a, b in sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                       for e in inside):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    per_op: dict = {}
    for e in inside:
        per_op[e["name"]] = per_op.get(e["name"], 0.0) + e["dur"]
    out.update(flush_window_ms=(hi - lo) / 1e3, busy_ms=busy / 1e3,
               busy_share=busy / (hi - lo), flush_device_events=len(inside),
               top5=[(name[:80], us / 1e3) for name, us in sorted(
                   per_op.items(), key=lambda kv: -kv[1])[:5]])
    return out


def _p3_start_cli(workdir: str, dd_url: str) -> dict:
    """The port's server CLI on the card, started ahead (its start-up
    overlaps P1): UDP DogStatsD and the HTTP API at fixed ports,
    `interval: 1s`, flush_on_shutdown, a datadog sink at the capturing
    fake; its log (and its replacement's) in workdir."""
    udp_port, http_port = _free_port(), _free_port()
    cfg = os.path.join(workdir, "p3.yaml")
    with open(cfg, "w") as f:
        json.dump({"statsd_listen_addresses": [f"udp://127.0.0.1:{udp_port}"],
                   "http_address": f"127.0.0.1:{http_port}",
                   "interval": "1s", "flush_on_shutdown": True,
                   "hostname": "smoke-p3", "stats_address": "",
                   "metric_sinks": [{"kind": "datadog", "name": "datadog",
                                     "config": {
                                         "datadog_api_key": "smoke",
                                         "datadog_api_hostname": dd_url}}]},
                  f)
    log_path = os.path.join(workdir, "p3.log")
    log = open(log_path, "w")
    # a process group of its own: the SIGUSR2 replacement joins it, so
    # one killpg stops both whatever state a failure left them in
    proc = subprocess.Popen(
        [sys.executable, "-m", "veneur_tpu_torch.cmd.veneur", "-f", cfg],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    log.close()
    return {"proc": proc, "udp": udp_port, "http": http_port,
            "log": log_path}


def _p3_ready_pid(http_port: int):
    """The pid that answered /healthcheck/ready 200, else None."""
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http_port}/healthcheck/ready",
                timeout=2) as r:
            if r.status == 200:
                return int(r.headers.get("X-Veneur-Pid", "0"))
    except Exception:
        return None
    return None


def _p3_gone(pid: int) -> bool:
    """True once `pid` has exited (a reparented zombie counts)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            return any(line.startswith("State:") and "Z" in line.split()[1]
                       for line in f)
    except OSError:
        return True


def _p3_log_tail(cli) -> str:
    with open(cli["log"]) as f:
        return f.read()[-4000:]


def _phase_p3(cli, dd_fake) -> dict:
    """The SIGUSR2 handoff of the CLI on the card: counter lines paced at
    PHASE_P3_RATE over four sockets and a TCP connect to the HTTP port
    every 20 ms, from before the signal until after the old process
    exited; the replacement is then stopped. No connect refused, the
    ready pid moves to the replacement, the old process exits 0 after
    its shutdown flush, the counter total the two delivered equals the
    lines they received, and at most 1 % of what was sent is lost."""
    import re
    import signal
    old, http_port = cli["proc"], cli["http"]
    t0 = time.perf_counter()
    deadline = time.monotonic() + 120
    while _p3_ready_pid(http_port) != old.pid:
        if old.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"phase P3: the CLI never became ready: "
                                 f"{_p3_log_tail(cli)}")
        time.sleep(0.2)
    startup_wait_s = time.perf_counter() - t0
    stop = threading.Event()
    counts = {"sent": 0, "probes": 0, "refused": 0, "probe_errors": {}}

    def send():
        dgram = b"\n".join([b"p3.c:1|c"] * PHASE_P3_PER_DGRAM)
        socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                 for _ in range(4)]
        start, i = time.perf_counter(), 0
        try:
            while not stop.is_set():
                ahead = counts["sent"] / PHASE_P3_RATE - (
                    time.perf_counter() - start)
                if ahead > 0:
                    time.sleep(ahead)
                socks[i % 4].sendto(dgram, ("127.0.0.1", cli["udp"]))
                counts["sent"] += PHASE_P3_PER_DGRAM
                i += 1
        finally:
            for s in socks:
                s.close()

    def probe():
        # a client's connect: a SYN the listener's queue drops is sent
        # again, so only a refusal means no listener on the port
        while not stop.is_set():
            counts["probes"] += 1
            try:
                socket.create_connection(("127.0.0.1", http_port),
                                         timeout=10).close()
            except ConnectionRefusedError:
                counts["refused"] += 1
            except OSError as e:
                kind = type(e).__name__
                counts["probe_errors"][kind] = \
                    counts["probe_errors"].get(kind, 0) + 1
            stop.wait(PHASE_P3_PROBE_S)

    threads = [threading.Thread(target=send, name="p3-send"),
               threading.Thread(target=probe, name="p3-probe")]
    for t in threads:
        t.start()
    try:
        time.sleep(1.0)
        t_sig = time.perf_counter()
        old.send_signal(signal.SIGUSR2)
        new_pid = None
        deadline = time.monotonic() + 120
        while new_pid is None:
            pid = _p3_ready_pid(http_port)
            if pid and pid != old.pid:
                new_pid = pid
            elif time.monotonic() > deadline:
                raise AssertionError(f"phase P3: no replacement became "
                                     f"ready: {_p3_log_tail(cli)}")
            else:
                time.sleep(0.1)
        ready_s = time.perf_counter() - t_sig
        rc = old.wait(timeout=120)
        old_exit_s = time.perf_counter() - t_sig
        if rc != 0:
            raise AssertionError(f"phase P3: the old process exited {rc}: "
                                 f"{_p3_log_tail(cli)}")
        time.sleep(1.0)
        if _p3_ready_pid(http_port) != new_pid:
            raise AssertionError("phase P3: the port is not the "
                                 "replacement's after the handoff")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    stop_s = time.perf_counter() - t_sig
    os.kill(new_pid, signal.SIGTERM)
    deadline = time.monotonic() + 120
    while not _p3_gone(new_pid):
        if time.monotonic() > deadline:
            os.kill(new_pid, signal.SIGKILL)
            raise AssertionError(f"phase P3: the replacement did not exit: "
                                 f"{_p3_log_tail(cli)}")
        time.sleep(0.1)
    with open(cli["log"]) as f:
        log = f.read()
    received = {int(pid): int(n) for pid, n in re.findall(
        r"shutdown of pid (\d+) complete: (\d+) lines received", log)}
    if set(received) != {old.pid, new_pid}:
        raise AssertionError(f"phase P3: shutdown counts {received}: "
                             f"{log[-4000:]}")
    import gzip
    delivered, posts = 0.0, []
    for t, path, encoding, body in dd_fake.take_timed():
        if not path.startswith("/api/v1/series"):
            continue
        if encoding == "gzip":
            body = gzip.decompress(body)
        for series in json.loads(body)["series"]:
            if series["metric"] == "p3.c":
                value = sum(p[1] for p in series["points"])
                delivered += value
                posts.append((round(t - t_sig, 3), value))
    total_received = sum(received.values())
    lost = counts["sent"] - total_received
    report = {"sent": counts["sent"], "received": received,
              "delivered": delivered, "lost": lost,
              "lost_share": lost / max(1, counts["sent"]),
              "probes": counts["probes"], "refused": counts["refused"],
              "probe_errors": counts["probe_errors"],
              "old_pid": old.pid, "new_pid": new_pid,
              "startup_wait_s": startup_wait_s, "ready_s": ready_s,
              "old_exit_s": old_exit_s, "stop_s": stop_s,
              # (seconds after the signal, p3.c total) of each delivery
              "posts": posts,
              # the two processes' flushes whose sinks outlasted the
              # interval, and the sink deliveries skipped as pileups
              "sink_timeouts": log.count("flush exceeded the"),
              "sink_skips": log.count("previous flush still running")}
    if counts["refused"]:
        raise AssertionError(f"phase P3: connects refused: {report}")
    if delivered != total_received:
        # the two processes' warnings and errors: skips, timeouts, failed
        # POSTs, lines discarded at close
        noted = [line for line in log.splitlines()
                 if " WARNING " in line or " ERROR " in line
                 or "Traceback" in line]
        raise AssertionError(f"phase P3: delivered {delivered} != "
                             f"received {total_received}: {report}; the "
                             f"CLI's warnings and errors: {noted[-40:]}")
    if report["lost_share"] > 0.01:
        raise AssertionError(f"phase P3: lost {lost} of {counts['sent']}: "
                             f"{report}")
    return report


def _phase_p12(cli) -> dict:
    """P1, the device plane, and P2, the profiles, on one server at phase
    D's local width (A's keys + 5 000 `|l` keys x 32) with the device
    observatory on: the HBM ledger held to the tensors after every swap,
    readout, recycle, prewarm and resize; interval 2's CPU profile and a
    device trace over its tail and flush; a prewarm rung and a forced
    doubling of the llhist table inside flush 3's readout, where the
    device watermark rung (its soft threshold set between the totals
    before and after the doubling) goes degraded and sheds a tenth of
    A's timer and set samples, then back to ok when the recycle releases
    the old generation. The kernel registry's launches equal the
    wrappers' counts."""
    from veneur_tpu_torch.core import overload as ov
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    corpora = [_corpus(seed, PHASE_A_KEYS, PHASE_P_LL_KEYS) + (
        _set_reference(seed, PHASE_A_KEYS["set"],
                       PHASE_A_KEYS["set_members"]),)
        for seed in PHASE_P_SEEDS]
    server = _server({"device_observatory": True, "ledger_strict": True,
                      "http_address": "127.0.0.1:0",
                      # the rung is engaged but ticked by hand; its soft
                      # threshold is set from the measured totals
                      "overload_device_soft_bytes": 1 << 50,
                      "overload_watermark_poll": "1h"},
                     {"counter_capacity": 65536, "gauge_capacity": 32768,
                      "histo_capacity": 32768, "set_capacity": 16384,
                      "llhist_capacity": 8192}, ChannelMetricSink())
    led = _PLedger(server)
    dw = server.overload.device_watermarks
    sink = server.metric_sinks[0]
    check = _check_a_or_c(PHASE_A_KEYS)
    report = {"intervals": [], "ledger": []}
    _zero_launches()
    server.start()
    try:
        api = server.http_api.address
        addr = server.listen_addresses[0]
        window = _pump_window(server)
        led.check("start")
        report["ledger"].append(led.snapshot("start"))
        base = 0
        for i, corpus in enumerate(corpora):
            lines = corpus[0]
            rec = {"lines": len(lines)}
            if i == 1:
                prof = {}
                pth = threading.Thread(target=lambda: prof.update(
                    http=_http(api, "/debug/pprof/profile?seconds=2")))
                pth.start()
                cut = len(lines) - len(lines) // PHASE_P_TAIL
                ingest_s = _send(server, addr, lines[:cut], base, window)
                pth.join(timeout=120)
                from veneur_tpu_torch.core import profiling
                trace = {}
                tth = threading.Thread(target=lambda: trace.update(
                    http=_http(api, "/debug/profile/device?seconds="
                               f"{PHASE_P_TRACE_S}")))
                tth.start()
                # the capture's profiler records before the tail is sent
                # (it arms the span recorder inside its window)
                t_wait = time.monotonic() + 60
                while not profiling.armed:
                    if time.monotonic() > t_wait:
                        raise AssertionError("phase P2: the device capture "
                                             "never started")
                    time.sleep(0.01)
                ingest_s += _send(server, addr, lines[cut:], base + cut,
                                  window)
                t_flush = time.perf_counter()
                window_unix = [time.time()]
                server.flush()
                window_unix.append(time.time())
                flush_s = time.perf_counter() - t_flush
                tth.join(timeout=120)
                rec["pprof"], rec["device_trace"] = prof["http"], \
                    trace["http"]
                rec["flush_window_unix"] = window_unix
            else:
                ingest_s = _send(server, addr, lines, base, window)
                t_flush = time.perf_counter()
                server.flush()
                flush_s = time.perf_counter() - t_flush
            base += len(lines)
            got, buckets = _collect(sink)
            rec.update(ingest_s=ingest_s, lines_per_s=len(lines) / ingest_s,
                       flush_s=flush_s, flush=dict(server.last_flush_timings),
                       rung=dw.tick(), **check(corpus, got, buckets))
            if rec["rung"] != ov.OK:
                raise AssertionError(f"phase P1: rung {rec['rung']}")
            report["intervals"].append(rec)
            report["ledger"].append(led.snapshot(f"flush {i + 1}"))

        # -- P2's answers ------------------------------------------------
        status, body = report["intervals"][1].pop("pprof")
        if status != 200:
            raise AssertionError(f"phase P2: pprof {status} {body[:200]}")
        strings = _p_pprof_strings(body)
        ingest_frames = sorted({s for s in strings
                                if s.endswith(("core/ingest.py",
                                               "core/networking.py"))})
        if not ingest_frames:
            raise AssertionError("phase P2: no ingest frame in the CPU "
                                 "profile")
        report["pprof"] = {"bytes": len(body), "strings": len(strings),
                           "ingest_files": ingest_frames}
        status, body = report["intervals"][1].pop("device_trace")
        if status == 200:
            import io
            import zipfile
            zf = zipfile.ZipFile(io.BytesIO(body))
            summary = json.loads(zf.read("summary.json"))
            numbers = _p_trace_numbers(
                json.loads(zf.read("trace.json")),
                report["intervals"][1].pop("flush_window_unix"))
            missing = [k for k, v in numbers["kernels"].items()
                       if not v["events"]]
            if missing:
                raise AssertionError(f"phase P2: the device trace holds "
                                     f"no {missing} events: {numbers}")
            report["device_trace"] = {"status": 200, "summary": summary,
                                      "zip_bytes": len(body), **numbers}
        elif status == 503 and b"no device activity" in body:
            # the card's host gives no CUPTI events: said, not hidden
            report["device_trace"] = {"status": 503,
                                      "reason": body.decode().strip()}
        else:
            raise AssertionError(f"phase P2: device trace {status} "
                                 f"{body[:300]}")

        # -- a prewarm rung of the llhist table ----------------------------
        ll = server.store.llhists
        before = server.deviceobs.total_bytes()
        if not ll.prewarm_rung(2 * ll.capacity, PS):
            raise AssertionError("phase P1: the llhist rung did not run")
        rung_bytes = _p_nbytes(ll._fresh_state_at(2 * ll.capacity))
        if led.prewarm_mid != rung_bytes or \
                server.deviceobs.total_bytes() != before:
            raise AssertionError(f"phase P1: prewarm booked "
                                 f"{led.prewarm_mid} of {rung_bytes}")
        report["prewarm"] = {"capacity": 2 * ll.capacity,
                             "bytes": rung_bytes}
        report["ledger"].append(led.snapshot("prewarm"))

        # -- flush 3: the forced doubling inside the llhist readout --------
        soft_keys = {k: v // 10 for k, v in PHASE_A_KEYS.items()
                     if k in ("timer", "set")}
        rng = np.random.default_rng(63)
        soft_lines = [f"smoke.t{k}:{v:.3f}|ms"
                      for k in range(soft_keys["timer"])
                      for v in rng.gamma(2.0, 25.0, PHASE_A_KEYS[
                          "timer_samples"])]
        soft_lines += [f"smoke.s{k}:p3-{k}-{j}|s"
                       for k in range(soft_keys["set"])
                       for j in range(PHASE_A_KEYS["set_members"])]
        soft_sent = {"histogram": soft_keys["timer"]
                     * PHASE_A_KEYS["timer_samples"],
                     "set": soft_keys["set"] * PHASE_A_KEYS["set_members"]}
        rung = {}

        def applied() -> dict:
            rep = server.ledger.report()
            out = {}
            for stages in (rep["stage_totals"], rep["pending_stages"]):
                for fam, n in stages.get("agg.applied", {}).items():
                    out[fam] = out.get(fam, 0.0) + n
            return out

        def double_in_readout():
            led.hooks.pop(("llhist", "readout"))
            live = _p_nbytes(ll.state)
            t_before = server.deviceobs.total_bytes()
            dw.soft_bytes = t_before + live // 2
            with ll.lock:
                ll._grow()
            rung.update(before=t_before, live=live, soft=dw.soft_bytes,
                        after=server.deviceobs.total_bytes(),
                        state=dw.tick())
            rung["device_report"] = json.loads(_http(api, "/debug/device")[1])[
                "watermarks"]
            shed0, applied0 = server.overload.shed_snapshot(), applied()
            n = base + len(ll3)
            rung["soft_ingest_s"] = _send(server, addr, soft_lines, n,
                                          window)
            rung["shed"] = {k: v - shed0.get(k, 0) for k, v in
                            server.overload.shed_snapshot().items()
                            if v - shed0.get(k, 0)}
            rung["applied0"] = applied0
        ll3 = [f"smoke.l{k}:{1.5 + k % 7}|l" for k in range(2_000)]
        _send(server, addr, ll3, base, window)
        led.hooks[("llhist", "readout")] = double_in_readout
        server.flush()  # flush 3
        base += len(ll3) + len(soft_lines)
        _collect(sink)
        rung["after_recycle"] = server.deviceobs.total_bytes()
        rung["state_after_recycle"] = dw.tick()
        report["ledger"].append(led.snapshot("flush 3 (doubled)"))
        server.flush()  # flush 4: the soft interval's kept samples
        _collect(sink)
        rung["after_flush4"] = server.deviceobs.total_bytes()
        rung["state_after_flush4"] = dw.tick()
        report["ledger"].append(led.snapshot("flush 4"))
        now = applied()
        kept = {"histogram": sum(now.get(f, 0) - rung["applied0"].get(f, 0)
                                 for f in ("histogram", "llhist")),
                "set": now.get("set", 0) - rung["applied0"].get("set", 0)}
        rung.pop("applied0")
        rung["kept"] = kept
        rung["soft_sent"] = soft_sent
        for cls in ("histogram", "set"):
            if kept[cls] + rung["shed"].get(f"{cls}|degraded", 0) \
                    != soft_sent[cls] or not rung["shed"].get(
                        f"{cls}|degraded"):
                raise AssertionError(f"phase P1 rung: {cls} kept "
                                     f"{kept[cls]} + shed {rung['shed']} "
                                     f"!= sent {soft_sent[cls]}")
        report["rung"] = rung
        status, body = _http(api, "/debug/device")
        device = json.loads(body)
        prom = {k: [v for _labels, v in vals] for k, vals in
                _g_prom_rows(_http(api, "/metrics")[1].decode()).items()
                if "overload_device" in k}
        events = [(e["old"], e["new"]) for e in
                  server.telemetry.events.snapshot(kind="overload_state")]
        report["rung"].update(events=events, final=device["watermarks"],
                              prom=prom, capacity=ll.capacity)
        if (rung["state"] != ov.DEGRADED
                or rung["device_report"]["state"] != ov.DEGRADED
                or rung["state_after_recycle"] != ov.OK
                or rung["after"] - rung["before"] != rung["live"]
                or events != [(ov.OK, ov.DEGRADED), (ov.DEGRADED, ov.OK)]
                or device["watermarks"]["transitions"] != 2
                or ll.capacity != 16384
                or not any(v == [2.0] for k, v in prom.items()
                           if "transitions" in k)):
            raise AssertionError(f"phase P1 rung: {report['rung']}")
        report["device_report"] = {
            k: device[k] for k in ("reconciliation", "backend_devices",
                                   "kernel_launches", "compiles",
                                   "last_compile_seconds")}
        # the observatory's own cost: every registry row is one hook, and
        # a flush makes at most three ledger calls a family
        cost = _p_hook_cost(server.store.counters)
        hooks = sum(k["dispatches"] for k in device["kernels"])
        flushes = sum(rec["flush_s"] for rec in report["intervals"])
        cost["hooks"] = hooks
        cost["seconds"] = (hooks * cost["hook_us"]
                           + 4 * 15 * cost["retag_us"]) / 1e6
        cost["share_of_flush_wall"] = cost["seconds"] / flushes
        report["observatory_cost"] = cost
        report["registry"] = {
            f"{k['kind']}/{k['family']}": {
                "dispatches": k["dispatches"],
                "launches": k.get("launches", 0),
                "p50_s": k.get("wall", {}).get("p50")}
            for k in device["kernels"]}
    finally:
        server.shutdown()
    report["launches"] = _read_launches()
    booked = server.deviceobs.kernel_launches()
    report["registry_launches"] = {k: booked.get(k, 0)
                                   for k in report["launches"]}
    report["conservation_checks"] = led.checks
    if report["registry_launches"] != report["launches"] or \
            min(report["launches"].values()) <= 0:
        raise AssertionError(f"phase P1: registry launches "
                             f"{report['registry_launches']} != wrappers' "
                             f"{report['launches']}")
    for step in ("counter.swap_out", "llhist.readout", "set.recycle",
                 "llhist.grow", "llhist.prewarm_rung",
                 "llhist.prewarm (mid)"):
        if not led.checks.get(step):
            raise AssertionError(f"phase P1: no ledger check after {step}")
    return report


def _phase_p() -> dict:
    """Phase P: the device observatory, the profiling plane and the
    SIGUSR2 handoff (P1, P2, P3). The CLI of P3 starts first, so that its
    start-up overlaps P1."""
    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix="smoke-p3-")
    dd_fake = _Fake()
    cli = _p3_start_cli(workdir, dd_fake.url)
    try:
        t0 = time.perf_counter()
        report = {"P1": _phase_p12(cli)}
        report["P1"]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report["P3"] = _phase_p3(cli, dd_fake)
        report["P3"]["seconds"] = time.perf_counter() - t0
    finally:
        _kill_group(cli["proc"])
        dd_fake.close()
        shutil.rmtree(workdir, ignore_errors=True)
    report["launches"] = report["P1"]["launches"]
    return report


# ---------------------------------------------------------------------------
# phase M: the sharded serving plane
# ---------------------------------------------------------------------------

PHASE_M_SHARDS = 4
PHASE_M_SEEDS = (71, 72)
# M2 runs one interval (its second, steady-state one cut for the time
# limit, as D's and F's were)
PHASE_M2_SEEDS = PHASE_M_SEEDS[:1]
PHASE_M_LL_KEYS = PHASE_D_LL_KEYS  # A's widths plus B's `|l` keys x 32
PHASE_M_CHUNK = 65_536             # samples a decoded chunk (a pump chunk's)
PHASE_M_CAPS = {"counter_capacity": 65536, "gauge_capacity": 32768,
                "histo_capacity": 32768, "set_capacity": 16384,
                "llhist_capacity": 8192}
# family, its table, its keys' prefix and wire type
_M_FAMILIES = (("counter", "counters", "m1.c", "c"),
               ("gauge", "gauges", "m1.g", "g"),
               ("histogram", "histos", "m1.t", "ms"),
               ("llhist", "llhists", "m1.l", "l"),
               ("set", "sets", "m1.s", "s"))
_M_KERNELS = ("tdigest_flush", "hll_estimate", "llhist_apply")


@_prebuildable
def _m1_interval(seed: int) -> dict:
    """One interval of M1 as decoded columns per family, rows being key
    indices and each family's samples shuffled: phase A's counters
    (rates 1 and 0.5), gauges x 2, timers x 16 and sets x 32, and B's
    `|l` keys x 32 (rates 1 and 0.5, binned here); with the counters'
    totals."""
    from veneur_tpu_torch.ops import batch_llhist
    keys, rng = PHASE_A_KEYS, np.random.default_rng(seed)

    def spread(n, per):
        return rng.permutation(np.repeat(np.arange(n, dtype=np.int32), per))
    nc = keys["counter"]
    cvals = rng.integers(1, 1000, nc).astype(np.float32)
    crates = rng.choice(np.float32([1.0, 0.5]), nc)
    order = rng.permutation(nc).astype(np.int32)
    out = {"counter": (order, cvals[order], crates[order]),
           "counter_totals": np.trunc(cvals.astype(np.float64)
                                      / crates.astype(np.float64))}
    rows = spread(keys["gauge"], 2)
    out["gauge"] = (rows, rng.normal(0, 100, rows.size).astype(np.float32))
    rows = spread(keys["timer"], keys["timer_samples"])
    out["histogram"] = (rows, rng.gamma(2.0, 25.0, rows.size).astype(
        np.float32), np.ones(rows.size, np.float32))
    rows = spread(PHASE_M_LL_KEYS, 32)
    bins, wts = batch_llhist.bin_batch_host(
        10.0 ** rng.uniform(-3, 6, rows.size), np.where(rows % 2, 2.0, 1.0))
    out["llhist"] = (rows, bins, wts)
    rows = spread(keys["set"], keys["set_members"])
    member = np.empty(rows.size, np.int64)
    member[np.argsort(rows, kind="stable")] = np.tile(
        np.arange(keys["set_members"]), keys["set"])
    idx, rho = _member_regs([f"u{seed}-{k}-{j}".encode() for k, j in zip(
        rows.tolist(), member.tolist())])
    out["set"] = (rows, idx.astype(np.int32), rho.astype(np.int32))
    return out


def _m_store(shards: int, groups=None):
    """A ColumnStore at M's widths on cuda:0 (`shards` 0: single tables;
    set keys promote at 16 samples, the card's auto threshold; the shards
    over `groups`, default the first min(shards, C) cards) with a device
    observatory attached."""
    from veneur_tpu_torch.core.columnstore import ColumnStore
    from veneur_tpu_torch.core.deviceobs import DeviceObservatory
    store = ColumnStore(batch_cap=8192, set_promote_samples=16,
                        shard_devices=shards, shard_groups=groups,
                        **PHASE_M_CAPS)
    obs = DeviceObservatory()
    store.attach_deviceobs(obs)
    return store, obs


def _m1_intern(stores) -> None:
    """Intern M1's keys in every store in one order, so that row k of a
    family is its key k in each."""
    from veneur_tpu_torch.samplers.parser import Parser
    parser = Parser()
    keys = {"counter": PHASE_A_KEYS["counter"],
            "gauge": PHASE_A_KEYS["gauge"],
            "histogram": PHASE_A_KEYS["timer"], "llhist": PHASE_M_LL_KEYS,
            "set": PHASE_A_KEYS["set"]}
    for family, attr, prefix, kind in _M_FAMILIES:
        n = keys[family]
        stubs = []
        for k in range(n):
            parser.parse_metric_fast(f"{prefix}{k}:1|{kind}".encode(),
                                     stubs.append)
        for store in stores:
            table = getattr(store, attr)
            if [table.intern(stub) for stub in stubs] != list(range(n)):
                raise AssertionError(f"phase M1: {family} rows interned "
                                     f"out of order")


def _m1_feed(store, cols) -> float:
    """Every family's columns in decoded chunks, the families taking
    turns chunk by chunk as a pump's chunks carry them; returns the
    seconds to the device's completion."""
    t0 = time.perf_counter()
    adds = {"counter": store.counters.add_batch,
            "gauge": store.gauges.add_batch,
            "histogram": store.histos.add_batch,
            "llhist": store.llhists.add_batch_binned,
            "set": store.sets.add_batch}
    longest = max(len(cols[f][0]) for f in adds)
    for at in range(0, longest, PHASE_M_CHUNK):
        for family, add in adds.items():
            chunk = tuple(c[at:at + PHASE_M_CHUNK] for c in cols[family])
            if len(chunk[0]):
                add(*chunk)
    store.apply_all_pending()
    store.synchronize()
    return time.perf_counter() - t0


def _m_walk(store, held) -> int:
    """The bytes of the store's live and spare tensors and of the
    generations the flush holds."""
    from veneur_tpu_torch.core.deviceobs import nbytes_of
    return (sum(nbytes_of(t._devobs_state()) + nbytes_of(t._spare)
                for _family, t in store.tables())
            + sum(nbytes_of(h) for h in held))


def _m_merge_ms(store, snaps) -> dict:
    """Device ms of each family's merge over the swapped generation (the
    read-only merge, which leaves it to the readout), CUDA events."""
    from veneur_tpu_torch.parallel import collectives as coll

    def touched(family):
        return torch.from_numpy(np.flatnonzero(
            snaps[family]["touched"])).to(store.device)
    ll_rows, set_rows = touched("llhist"), touched("set")
    state = {f: snap["state"] for f, snap in snaps.items()}
    dev, plane = store.device, store.shard_plane
    fns = {"counter": lambda: coll.merge_counters_stacked(state["counter"],
                                                          dev),
           "gauge": lambda: coll.merge_gauges_stacked(state["gauge"], dev),
           "histogram": lambda: coll.merge_histo_stacked(
               state["histogram"], dev),
           "llhist": lambda: coll.merge_llhist_stacked(state["llhist"], dev,
                                                       ll_rows),
           "set": lambda: coll.merge_hll_stacked(state["set"], plane,
                                                 set_rows)}
    return {f: _time_ms(fn, reps=2, runs=3) for f, fn in fns.items()}


def _m1_flush(store, obs=None, merge_ms=None) -> tuple:
    """Flush every family table by table (swap, readout, host copy,
    recycle) as a forwarding local does (with the t-digest export),
    holding the HBM ledger `obs` to the tensors after every step;
    returns the readouts and the ledger checks made."""
    kw = {"histogram": {"ps": PS, "need_export": True}, "llhist": {"ps": PS}}
    tables = [(f, getattr(store, attr)) for f, attr, *_ in _M_FAMILIES]
    snaps, out, checks = {}, {}, [0]

    def check(step):
        if obs is None:
            return
        held = [s.get("state", s.get("_spare", s.get("_recycle")))
                for s in snaps.values()]
        if obs.total_bytes() != _m_walk(store, held):
            raise AssertionError(
                f"phase M1: after the {step} the ledger holds "
                f"{obs.total_bytes()} bytes, the tensors "
                f"{_m_walk(store, held)}")
        checks[0] += 1
    for family, table in tables:
        snaps[family] = table.swap_out(**kw.get(family, {}))
        check(f"{family} swap")
    if merge_ms is not None:
        merge_ms.update(_m_merge_ms(store, snaps))
    for family, table in tables:
        table.readout(snaps[family])
        check(f"{family} readout")
    store.synchronize()
    for family, table in tables:
        out[family] = table.snapshot_finish(snaps[family])
    for family, table in tables:
        table.recycle(snaps.pop(family))
        check(f"{family} recycle")
    return out, checks[0]


def _m_busy(run) -> tuple:
    """Run `run` under torch.profiler; returns its result and its wall
    time with the device's busy share of it (the union of the trace's
    kernel, copy and set intervals) and the five device operations that
    took longest in all, None where the trace holds no device event."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", ())
    ops = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in ops)
    per_op: dict = {}
    for e in ops:
        per_op[e["name"][:60]] = per_op.get(e["name"][:60], 0.0) + e["dur"]
    rec = {"wall_s": wall, "device_events": len(device), "busy_ms": None,
           "busy_share": None, "top5_ms": [
               (name, us / 1e3) for name, us in sorted(
                   per_op.items(), key=lambda kv: -kv[1])[:5]]}
    if device:
        busy, end = 0.0, device[0][0]
        for a, b in device:
            if b > end:
                busy += b - max(a, end)
                end = b
        rec["busy_ms"] = busy / 1e3
        rec["busy_share"] = busy / 1e6 / wall
    return result, rec


def _m1_compare(got: dict, want: dict, totals: np.ndarray) -> int:
    """The sharded store's readouts against the single store's: counters
    (and the totals sent), gauges, llhist registers, counts and
    quantiles, HLL registers and estimates bit for bit, the llhist sums
    to 1e-6; the t-digest's count, mass, moments, min, max and
    reciprocal sum within tests/test_sharded_store.py's slack, its
    quantiles within that file's 5 % + 1.5."""
    checked = 0
    for family in ("counter", "gauge"):
        vals, touched, _meta = got[family]
        wvals, wtouched, _ = want[family]
        if not (np.array_equal(touched, wtouched)
                and np.array_equal(vals[touched], wvals[wtouched])):
            raise AssertionError(f"phase M1: sharded {family} values differ "
                                 f"from the single store's")
        checked += int(touched.sum())
    if not np.array_equal(got["counter"][0][: totals.size], totals):
        raise AssertionError("phase M1: counter totals differ from what was "
                             "sent")
    out, bins, touched, _ = got["llhist"]
    wout, wbins, wtouched, _ = want["llhist"]
    if not (np.array_equal(touched, wtouched) and np.array_equal(bins, wbins)
            and np.array_equal(out["count"], wout["count"])
            and np.array_equal(out["quantiles"], wout["quantiles"])
            and np.allclose(out["sum"], wout["sum"], rtol=1e-6, atol=0)):
        raise AssertionError("phase M1: sharded llhist registers or readout "
                             "differ from the single store's")
    checked += int(touched.sum()) * (2 + len(PS))
    est, regs, touched, _ = got["set"]
    west, wregs, wtouched, _ = want["set"]
    rows = np.flatnonzero(touched)
    if not (np.array_equal(touched, wtouched)
            and np.array_equal(est[rows], west[rows])):
        raise AssertionError("phase M1: sharded set estimates differ")
    bad = [r for r in rows.tolist() if not np.array_equal(regs[r], wregs[r])]
    if bad:
        raise AssertionError(f"phase M1: HLL registers of {len(bad)} set "
                             f"rows differ, e.g. row {bad[0]}")
    checked += 2 * rows.size
    (out, exp, touched, _), (wout, wexp, wtouched, _) = (got["histogram"],
                                                         want["histogram"])
    rows = np.flatnonzero(touched)
    m, w, dmin, dmax, recip = (a[rows] for a in exp)
    wm, ww, wmin, wmax, wrecip = (a[rows] for a in wexp)

    def close(a, b, rtol, atol=0.0):
        return np.allclose(a, b, rtol=rtol, atol=atol)
    ok = (np.array_equal(touched, wtouched)
          and close(w.sum(-1), ww.sum(-1), 1e-5)
          and close((m * w).sum(-1), (wm * ww).sum(-1), 1e-4)
          and close(dmin, wmin, 1e-6) and close(dmax, wmax, 1e-6)
          and close(recip, wrecip, 1e-5)
          and all(close(out[k][rows], wout[k][rows], 1e-6)
                  for k in ("count", "min", "max"))
          and close(out["quantiles"][rows], wout["quantiles"][rows], 0.05,
                    1.5))
    if not ok:
        raise AssertionError("phase M1: the sharded t-digest flush is "
                             "outside the single store's slack")
    return checked + 5 * rows.size


def _m_delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def _m_require(launches: dict, kernels, what: str) -> None:
    for kernel in kernels:
        if launches[kernel] <= 0:
            raise AssertionError(f"phase {what}: {kernel} was not launched")


def _phase_m1() -> dict:
    """M1: a 4-shard ColumnStore and a single one on cuda:0 take the same
    decoded columns in-process, two intervals; each flush is compared
    family by family, the shards' routed counts with what was sent, and
    the sharded store's HBM ledger with its tensors at every step. The
    launches are the sharded store's apply and flush alone."""
    intervals = [_m1_interval(seed) for seed in PHASE_M_SEEDS]
    sharded, obs = _m_store(PHASE_M_SHARDS)
    single, _single_obs = _m_store(0)
    plane = sharded.shard_plane
    _m1_intern((sharded, single))
    report = {"intervals": [], "ledger_checks": 0}
    path = {k: 0 for k in _M_KERNELS}
    sent = {f: 0 for f, *_ in _M_FAMILIES}
    _zero_launches()
    for i, cols in enumerate(intervals):
        rec = {}
        start = _read_launches()
        rec["feed_s"] = _m1_feed(sharded, cols)
        applied = _read_launches()
        if i:  # interval 2: the flush alone under the profiler, both stores
            (got, checks), rec["busy"] = _m_busy(
                lambda: _m1_flush(sharded, obs))
        else:  # interval 1: each family's merge timed inside the flush
            rec["merge_ms"] = {}
            got, checks = _m1_flush(sharded, obs, rec["merge_ms"])
        flushed = _read_launches()
        rec["launches"] = {"apply": _m_delta(start, applied),
                           "flush": _m_delta(applied, flushed)}
        _m_require(rec["launches"]["apply"], ("llhist_apply",),
                   "M1 sharded apply")
        _m_require(rec["launches"]["flush"], ("tdigest_flush",
                                              "hll_estimate"),
                   "M1 sharded flush")
        for k in path:
            path[k] += flushed[k] - start[k]
        report["ledger_checks"] += checks
        rec["single_feed_s"] = _m1_feed(single, cols)
        if i:
            (want, _), rec["single_busy"] = _m_busy(
                lambda: _m1_flush(single))
        else:
            want, _ = _m1_flush(single)
        rec["series_checked"] = _m1_compare(got, want,
                                            cols["counter_totals"])
        for family, *_ in _M_FAMILIES:
            sent[family] += len(cols[family][0])
        routed = {f: int(a.sum()) for f, a in plane._samples.items()}
        if routed != sent:
            raise AssertionError(f"phase M1: the shards routed {routed}, "
                                 f"{sent} were sent")
        rec["routed_per_shard"] = {f: a.tolist()
                                   for f, a in plane._samples.items()}
        report["intervals"].append(rec)
    report["ledger_bytes"] = obs.total_bytes()
    balance = obs.shard_balance()
    report["rows_per_shard"] = balance["rows_per_shard"]
    report["skew"] = balance["skew"]
    report["launches"] = path
    del sharded, single
    return report


@_prebuildable
def _m2_interval(seed: int):
    """One interval of M2's local: phase D's local corpus (A's key set,
    half the counters and gauges global-only, and 5 000 `|l` keys x 32)
    and the set reference over its 32 members."""
    part = _phase_d_corpus(seed, 0, PHASE_A_KEYS, PHASE_M_LL_KEYS)
    return part, _set_reference(seed, PHASE_A_KEYS["set"],
                                PHASE_A_KEYS["set_members"])


def _phase_m2() -> dict:
    """M2: a 4-shard local Server on the native pump, at phase D's local
    width, forwards to a 4-shard global Server over gRPC on 127.0.0.1,
    both on cuda:0, two intervals. The local's own series and the
    global's are checked as phase D checks them, and the global's
    `mesh.peer_shards` reads the local's 4 shards."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    intervals = [_m2_interval(seed) for seed in PHASE_M2_SEEDS]
    keys = PHASE_A_KEYS
    forwarded = (keys["counter"] // 2 + keys["gauge"] // 2 + keys["timer"]
                 + keys["set"] + PHASE_M_LL_KEYS)
    shards = {"shards": PHASE_M_SHARDS}
    gserver = _server({"grpc_address": "127.0.0.1:0",
                       "statsd_listen_addresses": []},
                      {**PHASE_M_CAPS, "counter_capacity": 32768, **shards},
                      ChannelMetricSink())
    _zero_launches()
    gserver.start()
    local = None
    report = {"intervals": []}
    path = {k: 0 for k in _M_KERNELS}
    try:
        imp = gserver.import_server
        local = _server({"forward_address": imp.address},
                        {**PHASE_M_CAPS, **shards}, ChannelMetricSink())
        local.start()
        window, base = _pump_window(local), 0
        for part, set_ref in intervals:
            rec = {"lines": len(part[0])}
            start = _read_launches()
            rec["ingest_s"] = _send(local, local.listen_addresses[0],
                                    part[0], base, window)
            base += len(part[0])
            stats = local.stats_snapshot()
            if (stats["lines_received"] != base or stats["lost_lines"]
                    or stats["ingest_dispatch_errors"]):
                raise AssertionError(f"phase M2 local: {stats}")
            applied = _read_launches()
            local.flush()
            flushed = _read_launches()
            rec["local_flush"] = dict(local.last_flush_timings)
            if local.stats_snapshot()["forward_errors"]:
                raise AssertionError(f"phase M2 local forward errors: "
                                     f"{local.stats_snapshot()}")
            if local.forward_client.last_flow != {
                    "received": forwarded, "merged": forwarded,
                    "duplicate": False}:
                raise AssertionError(f"phase M2: FlowCounts "
                                     f"{local.forward_client.last_flow}")
            gserver.flush()
            done = _read_launches()
            rec["global_flush"] = dict(gserver.last_flush_timings)
            rec["launches"] = {"local_apply": _m_delta(start, applied),
                               "local_flush": _m_delta(applied, flushed),
                               "global": _m_delta(flushed, done)}
            # the samples still pending at the flush are applied by its
            # readout: K3 counts over the apply and the flush
            _m_require(_m_delta(start, flushed), ("llhist_apply",),
                       "M2 sharded local apply")
            _m_require(rec["launches"]["local_flush"], (
                "tdigest_flush", "hll_estimate"), "M2 sharded local flush")
            _m_require(rec["launches"]["global"], (
                "tdigest_flush", "hll_estimate"), "M2 sharded global flush")
            for k in path:
                path[k] += done[k] - start[k]
            checked = _check_local(local, part, "phase M2 local")
            got, buckets = _collect(gserver.metric_sinks[0])
            rec.update(_check_global(got, buckets, part[2], part[3],
                                     part[4], part[5], set_ref,
                                     PHASE_A_KEYS["set_members"],
                                     "phase M2"))
            rec["series_checked"] += checked
            rec["peer_shards"] = imp.peer_shards
            rows = dict((r[0], r[2]) for r in imp.telemetry_rows())
            if imp.peer_shards != PHASE_M_SHARDS \
                    or rows["mesh.peer_shards"] != PHASE_M_SHARDS:
                raise AssertionError(f"phase M2: the global's "
                                     f"mesh.peer_shards reads "
                                     f"{rows['mesh.peer_shards']}")
            report["intervals"].append(rec)
        report["startup_mesh"] = [
            e.get("mesh") for s in (local, gserver)
            for e in s.telemetry.events.snapshot(kind="startup")]
        report["global_merge_rounds"] = gserver.store.shard_plane.merge_rounds
    finally:
        if local is not None:
            local.shutdown()
        gserver.shutdown()
    report["launches"] = path
    return report


def _phase_m() -> dict:
    """Phase M: M1, the sharded store against a single one, and M2, a
    sharded local forwarding to a sharded global."""
    t0 = time.perf_counter()
    m1 = _phase_m1()
    torch.cuda.empty_cache()
    m1["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    m2 = _phase_m2()
    m2["seconds"] = time.perf_counter() - t0
    return {"M1": m1, "M2": m2, "launches": {
        k: m1["launches"][k] + m2["launches"][k] for k in _M_KERNELS}}


# ---------------------------------------------------------------------------
# phase R: the elastic reshard
# ---------------------------------------------------------------------------

PHASE_R_SHARDS = (2, 3)             # N -> M (BASELINE.md config 10)
PHASE_R1_SEEDS = (81, 82)           # M1's decoded columns
PHASE_R2_SEEDS = (91, 92)           # phase A's corpus, sent in turns
PHASE_R2_RATE = 183_640             # phase A's steady rate, lines/s
PHASE_R2_INTERVALS = (3, 2)         # flushes before and after the cutover
_R_FAMILIES = ("counter", "gauge", "histogram", "llhist", "set")


class _TimedLock:
    """A server's flush lock, each hold timed by the holding thread's
    name."""

    def __init__(self, lock):
        self._lock = lock
        self.holds = []
        self._t = 0.0

    def __enter__(self):
        self._lock.acquire()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.holds.append((threading.current_thread().name,
                           time.perf_counter() - self._t))
        self._lock.release()


def _r_server(extra: dict, tpu: dict):
    """A 2-shard Server on cuda:0 with a strict ledger and a channel
    sink; its flush lock timed."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    server = _server({"ledger_strict": True, **extra},
                     {**tpu, "shards": PHASE_R_SHARDS[0]},
                     ChannelMetricSink())
    server._flush_lock = _TimedLock(server._flush_lock)
    return server


def _r_instrument(server) -> dict:
    """Time the cutover's parts on this server's controller: the capture
    (each family's reshard_swap, with the rows it moved), the encode,
    each WAL append, each segment's decode and merge-back."""
    from veneur_tpu_torch.forward import rangewire
    ctl = server.reshard
    split = {"capture_s": 0.0, "encode_s": 0.0, "wal_append_s": 0.0,
             "decode_s": 0.0, "merge_s": 0.0, "rows_moved": {},
             "segments_merged": 0}

    def timed(key, fn, after=None):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            split[key] += time.perf_counter() - t0
            if after is not None:
                after(out)
            return out
        return run

    for family, table in server.store.tables():
        if hasattr(table, "reshard_swap"):
            table.reshard_swap = timed(
                "capture_s", table.reshard_swap,
                lambda snap, f=family: split["rows_moved"].__setitem__(
                    f, int(snap["touched"].sum()) if "touched" in snap
                    else 0))
    ctl._encode_cells = timed("encode_s", ctl._encode_cells)
    spool = ctl._spool()
    if spool is not None:
        spool.append = timed("wal_append_s", spool.append)
    ctl._merge_decoded = timed(
        "merge_s", ctl._merge_decoded,
        lambda _n: split.__setitem__("segments_merged",
                                     split["segments_merged"] + 1))
    split["_decode"] = rangewire.decode_segment
    rangewire.decode_segment = timed("decode_s", rangewire.decode_segment)
    return split


def _r_uninstrument(split: dict) -> None:
    from veneur_tpu_torch.forward import rangewire
    rangewire.decode_segment = split.pop("_decode")


def _r_feed(server, cols) -> float:
    """M1's decoded columns into a server's store, the ingest identity's
    admitted side stamped as the ingesters stamp it."""
    seconds = _m1_feed(server.store, cols)
    server.ledger.note("ingest.admitted",
                       sum(len(cols[f][0]) for f in _R_FAMILIES),
                       key="smoke")
    return seconds


def _r_half(cols: dict, first: bool) -> dict:
    out = {}
    for family in _R_FAMILIES:
        n = len(cols[family][0]) // 2
        out[family] = tuple(c[:n] if first else c[n:] for c in cols[family])
    return out


def _r_flush(server) -> tuple:
    server.flush()
    got, buckets = _collect(server.metric_sinks[0])
    return got, buckets, server.last_flush_timings["total_s"]


def _r_compare(got: tuple, want: tuple, what: str) -> int:
    """tests/test_reshard.py's rule: every series equal to the control's,
    the t-digest percentile rows within rtol 1e-6."""
    (g, gb), (w, wb) = got[:2], want[:2]
    if set(g) != set(w) or gb != wb:
        raise AssertionError(
            f"phase {what}: series or buckets differ from the control: "
            f"{sorted(set(g) ^ set(w))[:5]}")
    def equal(k, v):
        if k.endswith("percentile"):
            return math.isclose(g[k], v, rel_tol=1e-6, abs_tol=0.0)
        if k.startswith("m1.l") and k.endswith(".sum"):
            # a dot product whose last bit follows the readout's rows
            return math.isclose(g[k], v, rel_tol=1e-12, abs_tol=0.0)
        return g[k] == v
    bad = [k for k, v in w.items() if not equal(k, v)]
    if bad:
        raise AssertionError(f"phase {what}: {len(bad)} series differ from "
                             f"the control, e.g. {bad[0]}: {g[bad[0]]} "
                             f"against {w[bad[0]]}")
    return len(w) + sum(len(v) for v in wb.values())


def _r_ledgers(*servers) -> int:
    """Every closed interval of each strict ledger balanced."""
    closed = 0
    for server in servers:
        for interval in server.ledger.history_imbalances():
            if any(v != 0.0 for v in interval.values()):
                raise AssertionError(f"phase R: ledger imbalance {interval}")
            closed += 1
        if any(v != 0.0 for v in server.ledger.imbalance_net.values()):
            raise AssertionError(f"phase R: ledger imbalance "
                                 f"{server.ledger.imbalance_net}")
    return closed


def _r_hbm(server, what: str) -> int:
    """The HBM ledger equal to the store's tensors, no capture left."""
    obs = server.deviceobs
    held = _m_walk(server.store, [])
    capture = sum(states.get("reshard_capture", 0)
                  for states in obs.ledger()["by_family"].values())
    if obs.total_bytes() != held or capture:
        raise AssertionError(f"phase {what}: the HBM ledger holds "
                             f"{obs.total_bytes()} bytes ({capture} of "
                             f"reshard_capture), the tensors {held}")
    return held


def _r_close(*servers) -> None:
    for server in servers:
        server.config.flush_on_shutdown = False
        server.shutdown()


def _phase_r1(workdir: str) -> dict:
    """R1: two 2-shard servers without listeners take M1's decoded
    columns; the first is resharded 2 -> 3 halfway through interval 1
    and holds interval 2 on the new plane, the second is the control;
    then a cutover killed after its segments are durable replays into a
    fresh 2-shard server."""
    from veneur_tpu_torch.parallel.reshard import ReshardError
    intervals = [_m1_interval(seed) for seed in PHASE_R1_SEEDS]
    caps = dict(PHASE_M_CAPS)
    server = _r_server({"statsd_listen_addresses": [],
                        "reshard_spool_dir": os.path.join(workdir, "wal")},
                       caps)
    control = _r_server({"statsd_listen_addresses": []}, caps)
    crashed = recovered = None
    report = {"intervals": []}
    try:
        _m1_intern((server.store, control.store))
        split = _r_instrument(server)
        try:
            _zero_launches()
            start = _read_launches()
            for i, cols in enumerate(intervals):
                rec = {}
                if i == 0:
                    rec["feed_s"] = _r_feed(server, _r_half(cols, True))
                    t0 = time.perf_counter()
                    server.reshard.begin(shards=PHASE_R_SHARDS[1],
                                         block=True)
                    rec["begin_s"] = time.perf_counter() - t0
                    rec["feed_s"] += _r_feed(server, _r_half(cols, False))
                    report["hbm_after_cutover"] = _r_hbm(server, "R1")
                else:
                    rec["feed_s"] = _r_feed(server, cols)
                applied = _read_launches()
                got = _r_flush(server)
                flushed = _read_launches()
                # interval 1's apply window holds the cutover's prewarm
                rec["launches"] = {
                    "apply" if i else "apply_and_cutover":
                    _m_delta(start, applied),
                    "flush": _m_delta(applied, flushed)}
                _m_require(_m_delta(start, flushed), _M_KERNELS,
                           f"R1 interval {i + 1}")
                start = flushed
                _r_feed(control, cols)
                want = _r_flush(control)
                rec["flush_s"], rec["control_flush_s"] = got[2], want[2]
                rec["series_equal"] = _r_compare(got, want, "R1")
                totals = cols["counter_totals"]
                if [got[0][f"m1.c{k}"] for k in range(totals.size)] \
                        != totals.tolist():
                    raise AssertionError("phase R1: counters differ from "
                                         "the totals sent")
                report["intervals"].append(rec)
            report["launches"] = {k: sum(
                part[k] for rec in report["intervals"]
                for part in rec["launches"].values()) for k in _M_KERNELS}
        finally:
            _r_uninstrument(split)
        ctl = server.reshard.describe()
        if (ctl["epoch"], ctl["shards"], ctl["inflight_metrics"]) != (
                1, PHASE_R_SHARDS[1], 0) or not ctl["segments_written"]:
            raise AssertionError(f"phase R1: controller {ctl}")
        report["controller"] = ctl
        report["split"] = split
        report["flush_lock_holds"] = [
            (name, s) for name, s in server._flush_lock.holds
            if name == "reshard-plan"]
        report["hbm_bytes"] = _r_hbm(server, "R1")
        report["plane"] = server.store.shard_plane.describe()
        _r_close(server)
        server = None
        torch.cuda.empty_cache()

        # the crash: every segment durable, the merge-back dies
        crash_dir = os.path.join(workdir, "crash")
        crashed = _r_server({"statsd_listen_addresses": [],
                             "reshard_spool_dir": crash_dir}, caps)
        _m1_intern((crashed.store,))
        _r_feed(crashed, intervals[0])

        def die(batch):
            raise RuntimeError("the merge-back killed after the WAL append")
        crashed.reshard._merge_decoded = die
        try:
            crashed.reshard.begin(shards=PHASE_R_SHARDS[1], block=True)
            raise AssertionError("phase R1: the killed cutover succeeded")
        except ReshardError:
            pass
        written = crashed.reshard.segments_written
        _r_close(crashed)
        crashed = None
        torch.cuda.empty_cache()
        recovered = _r_server({"statsd_listen_addresses": [],
                               "reshard_spool_dir": crash_dir}, caps)
        t0 = time.perf_counter()
        replayed = recovered.reshard.recover()
        replay_s = time.perf_counter() - t0
        again = recovered.reshard.recover()
        if not written or replayed != written or again != 0:
            raise AssertionError(f"phase R1 crash: {written} segments "
                                 f"written, {replayed} replayed, then "
                                 f"{again}")
        got = _r_flush(recovered)
        _r_feed(control, intervals[0])
        want = _r_flush(control)
        report["crash"] = {"segments_written": written,
                           "replayed": replayed, "replayed_again": again,
                           "replay_s": replay_s,
                           "series_equal": _r_compare(got, want,
                                                      "R1 crash replay")}
        report["ledger_intervals"] = _r_ledgers(control, recovered)
    finally:
        _r_close(*(s for s in (server, control, crashed, recovered)
                   if s is not None))
    return report


def _phase_r2(workdir: str) -> dict:
    """R2: a 2-shard server on the pump at phase A's widths, `interval:
    5s` on its own flush loop, fed paced UDP at phase A's steady rate;
    after three flushes `POST /reshard {"shards": 3}` while the load
    keeps flowing, then two more flushes; every counter's total over
    every interval equal to what was sent."""
    import urllib.request
    corpora = [_corpus(seed, PHASE_A_KEYS) for seed in PHASE_R2_SEEDS]
    server = _r_server({"interval": "5s", "flush_on_shutdown": True,
                        "http_address": "127.0.0.1:0",
                        "reshard_spool_dir": os.path.join(workdir, "r2")},
                       {"counter_capacity": 65536, "gauge_capacity": 32768,
                        "histo_capacity": 32768, "set_capacity": 16384})
    sink = server.metric_sinks[0]
    _zero_launches()
    server.start()
    report = {"rounds": 0}
    stop = threading.Event()
    sent_rounds, errors = [], []
    try:
        addr = server.listen_addresses[0]
        host, port = server.http_api.address
        base_url = f"http://{host}:{port}"
        window = _pump_window(server)

        def sender():
            base = 0
            try:
                while not stop.is_set():
                    lines = corpora[len(sent_rounds) % len(corpora)][0]
                    _send_at_rate(server, addr, lines, base, window,
                                  PHASE_R2_RATE)
                    base += len(lines)
                    sent_rounds.append(len(sent_rounds) % len(corpora))
            except Exception as e:  # reported by the main thread
                errors.append(e)
        thread = threading.Thread(target=sender, name="r2-sender",
                                  daemon=True)
        t_start = time.time()
        thread.start()

        def flushed():
            return len(server.telemetry.flushes.snapshot())

        def wait_flushes(n, what):
            deadline = time.monotonic() + 120.0
            while flushed() < n:
                if errors or time.monotonic() > deadline:
                    raise AssertionError(f"phase R2: {what}: {errors}")
                time.sleep(0.05)
        wait_flushes(PHASE_R2_INTERVALS[0], "no third flush")
        t_post = time.time()
        req = urllib.request.Request(
            base_url + "/reshard", data=json.dumps(
                {"shards": PHASE_R_SHARDS[1]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            if r.status != 202:
                raise AssertionError(f"phase R2: POST /reshard {r.status}")
        deadline = time.monotonic() + 120.0
        while True:
            with urllib.request.urlopen(base_url + "/debug/reshard",
                                        timeout=30) as r:
                state = json.loads(r.read())
            if state["state"] == "idle" and state["epoch"] == 1:
                break
            if state["last_error"] or time.monotonic() > deadline:
                raise AssertionError(f"phase R2: reshard {state}")
            time.sleep(0.05)
        t_done = time.time()
        if state["shards"] != PHASE_R_SHARDS[1]:
            raise AssertionError(f"phase R2: /debug/reshard {state}")
        wait_flushes(flushed() + PHASE_R2_INTERVALS[1],
                     "no flush after the cutover")
        stop.set()
        thread.join(timeout=120.0)
        if errors or thread.is_alive():
            raise AssertionError(f"phase R2: the sender failed: {errors}")
        report["rounds"] = len(sent_rounds)
        report["lines"] = sum(len(corpora[i][0]) for i in sent_rounds)
        report["send_s"] = time.time() - t_start
        stats = server.stats_snapshot()
        if (stats["lines_received"] != report["lines"]
                or stats["ingest_dispatch_errors"]):
            raise AssertionError(f"phase R2: sent {report['lines']}, "
                                 f"{stats}")
        with urllib.request.urlopen(base_url + "/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        report["reshard_rows"] = sorted({
            line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line.startswith("veneur_reshard_")})
        if len(report["reshard_rows"]) < 10:
            raise AssertionError(f"phase R2: /metrics reshard rows "
                                 f"{report['reshard_rows']}")
        report["debug_reshard"] = state
    finally:
        stop.set()
        server.shutdown()  # flush_on_shutdown: the last interval too
    report["launches"] = _read_launches()
    _m_require(report["launches"], ("tdigest_flush", "hll_estimate"),
               "R2 resharded server")
    totals: dict = {}
    for m in sink.drain():
        if m.name.startswith("smoke.c"):
            totals[m.name] = totals.get(m.name, 0.0) + m.value
    want: dict = {}
    for i in sent_rounds:
        for name, value in corpora[i][1].items():
            if name.startswith("smoke.c"):
                want[name] = want.get(name, 0.0) + value
    if totals != want:
        bad = sorted(k for k in want if totals.get(k) != want[k])
        raise AssertionError(f"phase R2: {len(bad)} counter totals differ "
                             f"from what was sent, e.g. {bad[:1]}")
    report["counters_checked"] = len(want)
    report["ledger_intervals"] = _r_ledgers(server)
    flushes = server.telemetry.flushes.snapshot()
    report["flushes"] = [
        ("before" if f["start_unix"] + f["duration_s"] < t_post else
         "after" if f["start_unix"] > t_done else "during",
         f["flush"], f["duration_s"]) for f in flushes]
    report["cutover"] = {
        "post_to_idle_s": t_done - t_post,
        "lock_hold_s": [s for name, s in server._flush_lock.holds
                        if name == "reshard-plan"],
        "last_cutover_seconds": server.reshard.last_cutover_seconds,
        "segments_written": server.reshard.segments_written}
    return report


def _phase_r() -> dict:
    """Phase R: R1, the in-process reshard against a control and the
    crash replay, and R2, a live reshard through POST /reshard."""
    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix="smoke-r-")
    try:
        t0 = time.perf_counter()
        r1 = _phase_r1(workdir)
        torch.cuda.empty_cache()
        r1["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r2 = _phase_r2(workdir)
        r2["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"R1": r1, "R2": r2, "launches": {
        k: r1["launches"][k] + r2["launches"][k] for k in _M_KERNELS}}


# ---------------------------------------------------------------------------
# phases X, Y and W: shards over several cards, and the SIGKILL soak
# ---------------------------------------------------------------------------

PHASE_X_SEEDS = PHASE_M_SEEDS      # M1's decoded columns, two intervals
PHASE_X_SLOTS = 4                  # mesh.full_step's slots
PHASE_X_KEYS = 100_000
PHASE_X_BATCH = 8192               # samples a slot
PHASE_X_SEED = 5
PHASE_Y_CARDS = 4
PHASE_Y_LOST = 3                   # the shard whose card device_loss drops


def _card0():
    return torch.device("cuda", 0)


def _all_cards() -> list:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _sync_cards() -> None:
    for dev in _all_cards():
        torch.cuda.synchronize(dev)


def _k3_counts(store) -> tuple:
    """Count the llhist table's K3 calls per placement group, and K3's
    launches per card, while the returned undo is not called: the
    wrappers count and call through (each kernel still counts its own
    launches)."""
    from veneur_tpu_torch.ops import llhist_apply
    from veneur_tpu_torch.parallel import collectives as coll
    table = store.llhists
    per_group: dict = {}
    per_card: dict = {}
    real_block, real_apply = coll.apply_llhist_block_sharded, \
        llhist_apply.apply

    def block(regs, blk):
        ids = {id(t): g for g, t in enumerate(coll.groups_of(table.state))}
        g = ids.get(id(regs), -1)
        per_group[g] = per_group.get(g, 0) + 1
        return real_block(regs, blk)

    def apply(regs, rows, bins, wts):
        if regs.is_cuda:
            key = f"cuda:{regs.device.index}"
            per_card[key] = per_card.get(key, 0) + 1
        return real_apply(regs, rows, bins, wts)

    coll.apply_llhist_block_sharded = block
    llhist_apply.apply = apply

    def undo():
        coll.apply_llhist_block_sharded = real_block
        llhist_apply.apply = real_apply
    return per_group, per_card, undo


def _copied_bytes() -> tuple:
    """Count the bytes the merges copy from one card to another (the
    partials and grids `_gathered` moves) until undo() is called."""
    from veneur_tpu_torch.parallel import collectives as coll
    real = coll._gathered
    moved = [0]

    def gathered(parts, device):
        device = torch.device(device)
        moved[0] += sum(p.numel() * p.element_size() for p in parts
                        if p.device != device)
        return real(parts, device)
    coll._gathered = gathered

    def undo():
        coll._gathered = real
    return moved, undo


def _x_compare(got: dict, want: dict, what: str) -> int:
    """A sharded store's flush against another sharded store's: counters,
    gauges, llhist registers and readouts (sums included: the same
    registers), HLL registers and estimates bit for bit; the t-digest
    readout and export within rtol 1e-6."""
    checked = 0
    for family in ("counter", "gauge"):
        vals, touched, _ = got[family]
        wvals, wtouched, _ = want[family]
        if not (np.array_equal(touched, wtouched)
                and np.array_equal(vals[touched], wvals[wtouched])):
            raise AssertionError(f"phase {what}: {family} values differ")
        checked += int(touched.sum())
    out, bins, touched, _ = got["llhist"]
    wout, wbins, wtouched, _ = want["llhist"]
    if not (np.array_equal(touched, wtouched) and np.array_equal(bins, wbins)
            and all(np.array_equal(out[k], wout[k]) for k in wout)):
        raise AssertionError(f"phase {what}: llhist registers or readout "
                             f"differ")
    checked += int(touched.sum()) * (2 + len(PS))
    est, regs, touched, _ = got["set"]
    west, wregs, wtouched, _ = want["set"]
    rows = np.flatnonzero(touched)
    if not (np.array_equal(touched, wtouched)
            and np.array_equal(est[rows], west[rows])
            and all(np.array_equal(regs[r], wregs[r]) for r in rows)):
        raise AssertionError(f"phase {what}: HLL registers or estimates "
                             f"differ")
    checked += 2 * rows.size
    (out, exp, touched, _), (wout, wexp, wtouched, _) = (got["histogram"],
                                                         want["histogram"])
    rows = np.flatnonzero(touched)
    if not (np.array_equal(touched, wtouched)
            and all(np.allclose(out[k][rows], wout[k][rows], rtol=1e-6,
                                atol=0.0) for k in wout)
            and all(np.allclose(a[rows], b[rows], rtol=1e-6, atol=0.0)
                    for a, b in zip(exp, wexp))):
        raise AssertionError(f"phase {what}: t-digest rows beyond rtol "
                             f"1e-6")
    return checked + len(wout) * rows.size


def _x_ledger_by_card(store, obs, what: str) -> dict:
    """The HBM ledger's bytes per device equal to the store's tensors on
    each device (live and spare generations, nothing in flight)."""
    from veneur_tpu_torch.core.deviceobs import bytes_by_device
    walk: dict = {}
    for _family, t in store.tables():
        for tree in (t._devobs_state(), t._spare):
            for dev, n in bytes_by_device(tree).items():
                walk[dev] = walk.get(dev, 0) + n
    booked = obs.ledger()["by_device"]
    if booked != walk:
        raise AssertionError(f"phase {what}: the ledger books {booked} "
                             f"per device, the tensors are {walk}")
    return booked


def _x_run(stores: dict, intervals, label: str, timed_merge: bool) -> dict:
    """Feed and flush named stores (interned alike) through M1's
    intervals; per interval the first store's flush against each other's
    (`_x_compare`, and the single store's slack for a store of single
    tables), its K3 calls per group and launches per card, each store's
    flush seconds and the bytes its merges copied between cards."""
    names = list(stores)
    first, (store0, obs0) = names[0], stores[names[0]]
    report = {"intervals": []}
    path = {k: 0 for k in _M_KERNELS}
    _zero_launches()
    for i, cols in enumerate(intervals):
        rec = {"feed_s": {}, "flush_s": {}, "copied_bytes": {}}
        outs = {}
        for name in names:
            store, obs = stores[name]
            start = _read_launches()
            if name == first:
                groups, cards, undo = _k3_counts(store)
            try:
                rec["feed_s"][name] = _m1_feed(store, cols)
            finally:
                if name == first:
                    undo()
            applied = _read_launches()
            if name == first:
                rec["k3_per_group"] = dict(sorted(groups.items()))
                rec["k3_per_card"] = dict(sorted(cards.items()))
                rec["launches"] = {"apply": _m_delta(start, applied)}
            merge_ms = {} if timed_merge and i == 0 \
                and store.shard_plane is not None else None
            moved, undo = _copied_bytes()
            try:
                t0 = time.perf_counter()
                # the single store's set readout lets its generation
                # escape into the register view, which no walk follows:
                # its ledger is not held to the tensors (as in M1)
                outs[name], _checks = _m1_flush(
                    store, obs if store.shard_plane is not None else None,
                    merge_ms)
                _sync_cards()
                rec["flush_s"][name] = time.perf_counter() - t0
            finally:
                undo()
            rec["copied_bytes"][name] = moved[0]
            if merge_ms is not None:
                rec.setdefault("merge_ms", {})[name] = merge_ms
            if name == first:
                flushed = _read_launches()
                rec["launches"]["flush"] = _m_delta(applied, flushed)
                _m_require(rec["launches"]["apply"], ("llhist_apply",),
                           f"{label} apply")
                _m_require(rec["launches"]["flush"], ("tdigest_flush",
                                                      "hll_estimate"),
                           f"{label} flush")
                for k in path:
                    path[k] += flushed[k] - start[k]
                if obs is not None:
                    rec["ledger_by_device"] = _x_ledger_by_card(store, obs,
                                                                label)
        rec["series_equal"] = {}
        for name in names[1:]:
            other = stores[name][0]
            if other.shard_plane is None:
                rec["series_equal"][name] = _m1_compare(
                    outs[first], outs[name], cols["counter_totals"])
            else:
                rec["series_equal"][name] = _x_compare(
                    outs[first], outs[name], f"{label} against {name}")
        report["intervals"].append(rec)
    report["launches"] = path
    report["plane"] = store0.shard_plane.describe()
    return report


def _phase_x1() -> dict:
    """X1: a 4-shard store in four placement groups on cuda:0 (the
    multi-card path on one card: per-group applies, partial merges and
    copies), the 4-shard store of one group and a single store take M1's
    decoded columns, two intervals; every series of the grouped store
    equals the one-group store's and the single store's, and K3 is
    called once per block and group."""
    intervals = [_m1_interval(seed) for seed in PHASE_X_SEEDS]
    card0 = _card0()
    stores = {"four_groups": _m_store(PHASE_M_SHARDS, [card0] * 4),
              "one_group": _m_store(PHASE_M_SHARDS, [card0]),
              "single": _m_store(0)}
    _m1_intern([s for s, _obs in stores.values()])
    report = _x_run(stores, intervals, "X1", timed_merge=True)
    for rec in report["intervals"]:
        calls = rec["k3_per_group"]
        if sorted(calls) != list(range(PHASE_M_SHARDS)) \
                or len(set(calls.values())) != 1:
            raise AssertionError(f"phase X1: K3 calls per group {calls}")
    del stores
    return report


def _phase_x2() -> dict:
    """X2: mesh.full_step with 4 slots on cuda:0 at 100 000 keys and 8192
    samples a slot, held to a single-device oracle as the JAX package's
    dryrun holds its step (__graft_entry__.py:64-177): counters and HLL
    registers exact, gauges by the last slot that set them, quantiles
    within the dryrun's slack; K1 and K2 run on the merged state."""
    from veneur_tpu_torch.ops import batch_hll, batch_tdigest
    from veneur_tpu_torch.parallel import mesh as pmesh
    card0 = _card0()
    n, num_keys = PHASE_X_SLOTS, PHASE_X_KEYS
    mesh = pmesh.make_mesh(n, devices=[card0])
    batches = pmesh.make_shard_batches(n, num_keys, PHASE_X_BATCH,
                                       seed=PHASE_X_SEED)
    state = pmesh.init_sharded_state(mesh, num_keys)
    _zero_launches()
    t0 = time.perf_counter()
    state, merged = pmesh.full_step(mesh, state, batches)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    ps = (0.5, 0.99)
    t0 = time.perf_counter()
    packed = batch_tdigest.flush_quantiles_packed(merged["histos"], ps,
                                                  fold_staging=False)
    est = batch_hll.estimate(merged["sets"])
    torch.cuda.synchronize()
    readout_s = time.perf_counter() - t0
    # the step's and its readout's launches; the oracle's below are not
    # the path's
    launches = _read_launches()
    _m_require(launches, ("tdigest_flush", "hll_estimate"), "X2")
    # counters: the exact sum of every slot's samples
    want = np.zeros(num_keys, np.float32)
    contrib = np.trunc(batches["c_vals"] / batches["c_rates"])
    np.add.at(want, batches["c_rows"].reshape(-1), contrib.reshape(-1))
    if not np.array_equal(merged["counters"].cpu().numpy(), want):
        raise AssertionError("phase X2: merged counters differ")
    # gauges: each slot's last write, the highest slot winning
    want_g = np.zeros(num_keys, np.float32)
    want_set = np.zeros(num_keys, bool)
    for slot in range(n):
        want_g[batches["g_rows"][slot]] = batches["g_vals"][slot]
        want_set[batches["g_rows"][slot]] = True
    got_set = merged["gauges"]["set"].cpu().numpy()
    got_g = merged["gauges"]["value"].cpu().numpy()
    if not (np.array_equal(got_set, want_set)
            and np.array_equal(got_g[want_set], want_g[want_set])):
        raise AssertionError("phase X2: merged gauges differ")
    # sets: the merged registers equal one apply of every slot's samples
    single = batch_hll.init_state(num_keys, card0)
    batch_hll.apply_batch(single, *(
        torch.from_numpy(batches[k].reshape(-1)).to(card0)
        for k in ("s_rows", "s_idx", "s_rho")))
    if not torch.equal(merged["sets"], single):
        raise AssertionError("phase X2: merged HLL registers differ")
    if not torch.equal(est, batch_hll.estimate(single)):
        raise AssertionError("phase X2: K2 on the merged registers differs")
    del single
    # histograms: quantiles against a single digest fed the whole stream
    single_td = batch_tdigest.init_state(num_keys, card0)
    h = {k: batches[k].reshape(-1) for k in ("h_rows", "h_vals", "h_wts")}
    batch_tdigest.apply_batch(single_td, *(
        torch.from_numpy(h[k]).to(card0) for k in ("h_rows", "h_vals",
                                                    "h_wts")))
    got_q = batch_tdigest.unpack_flush(packed.cpu().numpy(), len(ps))
    want_q = batch_tdigest.unpack_flush(batch_tdigest.flush_quantiles_packed(
        single_td, ps).cpu().numpy(), len(ps))
    touched = np.unique(h["h_rows"])
    gq, wq = got_q["quantiles"][touched], want_q["quantiles"][touched]
    # normal(100, 15) samples: twice the documented one-k-unit slack
    slack = 2 * 0.02 * 15 * 5
    if not (np.isfinite(gq).all() and np.abs(gq - wq).max() <= slack):
        raise AssertionError(f"phase X2: quantiles {np.abs(gq - wq).max()} "
                             f"from the oracle's, slack {slack}")
    if not np.array_equal(got_q["count"][touched],
                          want_q["count"][touched]):
        raise AssertionError("phase X2: digest counts differ")
    report = {"slots": n, "keys": num_keys, "batch": PHASE_X_BATCH,
              "step_s": step_s, "readout_s": readout_s,
              "max_quantile_diff": float(np.abs(gq - wq).max()),
              "touched": int(touched.size), "launches": launches}
    del state, merged, single_td
    return report


def _phase_x() -> dict:
    """Phase X: the multi-card path on one card (X1), and the multi-card
    dryrun (X2)."""
    t0 = time.perf_counter()
    x1 = _phase_x1()
    torch.cuda.empty_cache()
    x1["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x2 = _phase_x2()
    torch.cuda.empty_cache()
    x2["seconds"] = time.perf_counter() - t0
    return {"X1": x1, "X2": x2, "launches": {
        k: x1["launches"][k] + x2["launches"][k] for k in _M_KERNELS}}


def _phase_y1() -> dict:
    """Y1: the 4-shard store with each shard on its own card against the
    same store on card 0, M1's columns, two intervals: every series
    equal, K3 launched on every card, the HBM ledger equal to the tensors
    on every card."""
    intervals = [_m1_interval(seed) for seed in PHASE_X_SEEDS]
    cards = _all_cards()[:PHASE_Y_CARDS]
    stores = {"four_cards": _m_store(PHASE_M_SHARDS),
              "one_card": _m_store(PHASE_M_SHARDS, [cards[0]])}
    plane = stores["four_cards"][0].shard_plane
    if plane.devices != cards:
        raise AssertionError(f"phase Y1: shards placed on {plane.devices}")
    _m1_intern([s for s, _obs in stores.values()])
    report = _x_run(stores, intervals, "Y1", timed_merge=False)
    for rec in report["intervals"]:
        if sorted(rec["k3_per_card"]) != [f"cuda:{i}" for i in
                                          range(PHASE_Y_CARDS)]:
            raise AssertionError(f"phase Y1: K3 launched on "
                                 f"{rec['k3_per_card']}")
        if sorted(rec["ledger_by_device"]) != [f"cuda:{i}" for i in
                                               range(PHASE_Y_CARDS)]:
            raise AssertionError(f"phase Y1: ledger by card "
                                 f"{rec['ledger_by_device']}")
    del stores
    return report


def _phase_y2(workdir: str) -> dict:
    """Y2: two 4-shard servers over the four cards take M1's columns; the
    first loses shard 3's card halfway through interval 1
    (`device_loss(3)`: 4 -> 3 shards over cards 0-2) and holds interval
    2 on them, the second is the control that was never resharded."""
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    intervals = [_m1_interval(seed) for seed in PHASE_X_SEEDS]
    tpu = {**PHASE_M_CAPS, "shards": PHASE_M_SHARDS}
    server = _server({"statsd_listen_addresses": [], "ledger_strict": True,
                      "reshard_spool_dir": os.path.join(workdir, "wal")},
                     tpu, ChannelMetricSink())
    control = _server({"statsd_listen_addresses": [],
                       "ledger_strict": True}, tpu, ChannelMetricSink())
    report = {"intervals": []}
    try:
        _m1_intern((server.store, control.store))
        _zero_launches()
        start = _read_launches()
        for i, cols in enumerate(intervals):
            rec = {}
            if i == 0:
                rec["feed_s"] = _r_feed(server, _r_half(cols, True))
                t0 = time.perf_counter()
                server.reshard.device_loss(PHASE_Y_LOST, block=True)
                rec["device_loss_s"] = time.perf_counter() - t0
                rec["feed_s"] += _r_feed(server, _r_half(cols, False))
            else:
                rec["feed_s"] = _r_feed(server, cols)
            got = _r_flush(server)
            flushed = _read_launches()
            rec["launches"] = _m_delta(start, flushed)
            _m_require(rec["launches"], _M_KERNELS, f"Y2 interval {i + 1}")
            start = flushed
            _r_feed(control, cols)
            want = _r_flush(control)
            start = _read_launches()
            rec["flush_s"], rec["control_flush_s"] = got[2], want[2]
            rec["series_equal"] = _r_compare(got, want, "Y2")
            rec["ledger_by_device"] = _x_ledger_by_card(
                server.store, server.deviceobs, "Y2")
            report["intervals"].append(rec)
        plane = server.store.shard_plane
        if plane.devices != _all_cards()[:PHASE_Y_CARDS - 1]:
            raise AssertionError(f"phase Y2: after device_loss the shards "
                                 f"are on {plane.devices}")
        if sorted(report["intervals"][-1]["ledger_by_device"]) != [
                f"cuda:{i}" for i in range(PHASE_Y_CARDS - 1)]:
            raise AssertionError("phase Y2: the lost card still holds "
                                 "booked bytes")
        report["controller"] = server.reshard.describe()
        report["plane"] = plane.describe()
        report["ledger_intervals"] = _r_ledgers(server, control)
        report["launches"] = {k: sum(r["launches"][k]
                                     for r in report["intervals"])
                              for k in _M_KERNELS}
    finally:
        _r_close(server, control)
    return report


def _phase_y() -> dict:
    """Phase Y (named only, four cards): Y1, the store spread over the
    cards against the one-card store, and Y2, device_loss onto the cards
    that survive against a control."""
    import shutil
    import tempfile
    have = torch.cuda.device_count()
    if have < PHASE_Y_CARDS:
        raise AssertionError(f"phase Y needs {PHASE_Y_CARDS} cards, "
                             f"{have} visible")
    workdir = tempfile.mkdtemp(prefix="smoke-y-")
    try:
        t0 = time.perf_counter()
        y1 = _phase_y1()
        torch.cuda.empty_cache()
        y1["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        y2 = _phase_y2(workdir)
        y2["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"Y1": y1, "Y2": y2, "launches": {
        k: y1["launches"][k] + y2["launches"][k] for k in _M_KERNELS}}


def _phase_w() -> dict:
    """Phase W: one round of the SIGKILL reshard soak on cuda:0
    (veneur_tpu_torch/cmd/reshard_soak.py): a sharded child killed with
    its range segments durable, restarted at the old shard count, its
    replayed flush diffed against a never-resharded control. The
    children launch the kernels in their own processes, so this process
    counts none."""
    from veneur_tpu_torch.cmd import reshard_soak
    report = reshard_soak.run_soak(kills=1, device="cuda:0")
    if (report["kills"], report["restarts"]) != (1, 1) or not all(
            r["rows"] and r["segments"] for r in report["rounds"]):
        raise AssertionError(f"phase W: soak report {report}")
    report["launches"] = {k: 0 for k in _M_KERNELS}
    return report


PHASE_U_SEED = 111                 # phase A's corpus plus B's `|l` keys
PHASE_U_LL_KEYS = PHASE_F_LL_KEYS  # 5 000 `|l` keys x 32
PHASE_U_RATE = PHASE_R2_RATE       # phase A's steady rate, lines/s
PHASE_U_PER_DGRAM = 32             # lines in every datagram
PHASE_U_FLUSH_S = 1.0              # the smoke flushes once a second
PHASE_U_UNPACED_S = 5.0            # the unpaced pass
PHASE_Z_KILLS = 2
# tests/test_ha.py test_driver_soak's shape
PHASE_T = {"rounds": 16, "per_round": 250, "kill_round": 4,
           "restore_round": 10, "probe_interval": 0.05}
# in the side process (set by _SIDE): the main process runs beside it
_IN_SIDE = False
# the main phase from which on the main process sends no UDP: the
# side's unpaced flood waits for it (_main_quiet, _await_main_quiet)
QUIET_FROM = "X"


def _await_main_quiet() -> float:
    """In the side process: wait until the main process sends no more UDP
    of its own (it has reached QUIET_FROM, ended, or died), so that a
    burst at the loopback (phase U's unpaced pass) cannot cost a main
    phase its datagrams; the main process says so by closing the side's
    standard input. Returns the seconds waited."""
    t0 = time.perf_counter()
    if _IN_SIDE:
        sys.stdin.read()
    return time.perf_counter() - t0


def _u_datagrams(lines) -> tuple:
    """The lines padded with `smoke.upad` counter lines to a multiple of
    PHASE_U_PER_DGRAM and packed that many to a datagram, so that lines
    received count datagrams received; returns (padded lines, datagrams,
    pad lines)."""
    pad = -len(lines) % PHASE_U_PER_DGRAM
    lines = list(lines) + ["smoke.upad:1|c"] * pad
    dgrams = [("\n".join(lines[i:i + PHASE_U_PER_DGRAM])).encode()
              for i in range(0, len(lines), PHASE_U_PER_DGRAM)]
    if max(len(d) for d in dgrams) > DGRAM_BYTES:
        raise AssertionError("phase U: a datagram over DGRAM_BYTES")
    return lines, dgrams, pad


def _u_counter_totals(sink, totals: dict) -> None:
    """Add the drained counter series to `totals`."""
    for m in sink.drain():
        if m.name.startswith(("smoke.c", "smoke.upad")):
            totals[m.name] = totals.get(m.name, 0.0) + m.value


def _u_settle(server, want: int, timeout: float = 120.0) -> int:
    """Wait until `want` lines are received, or until the count has not
    moved for two seconds (datagrams lost); returns the count."""
    deadline = time.monotonic() + timeout
    last, still = -1, time.monotonic()
    while True:
        got = server.stats_snapshot()["lines_received"]
        if got >= want:
            return got
        if got != last:
            last, still = got, time.monotonic()
        elif time.monotonic() - still > 2.0 or time.monotonic() > deadline:
            return got
        time.sleep(0.01)


def _u_host_counts_drops(mon, n: int = 20_000) -> dict:
    """Whether this host's /proc/net/udp counts a socket's kernel drops:
    `n` 1000-byte datagrams at a small socket nobody reads, then its
    drops column against the datagrams it did not queue."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        rx.bind(("127.0.0.1", 0))
        tx.connect(rx.getsockname())
        for _ in range(n):
            tx.send(b"x" * 1000)
        drops = mon._read_proc().get(os.fstat(rx.fileno()).st_ino)
        rx.setblocking(False)
        queued = 0
        while True:
            try:
                rx.recv(2048)
            except BlockingIOError:
                break
            queued += 1
    finally:
        rx.close()
        tx.close()
    return {"sent": n, "queued": queued, "drops_column": drops,
            "counted": drops is not None and n > queued
            and drops == n - queued}


def _u_blast(blaster, fd: int, **kw) -> tuple:
    """Run the Blaster on a thread of its own; returns (thread, result
    list holding the datagrams sent and the seconds of the run, or the
    error)."""
    out: list = []

    def run():
        t0 = time.perf_counter()
        try:
            out.extend((blaster.run(fd, **kw), time.perf_counter() - t0))
        except Exception as e:  # reported by the caller
            out.append(e)
    thread = threading.Thread(target=run, name="u-blaster", daemon=True)
    thread.start()
    return thread, out


def _phase_u() -> dict:
    """Phase U: the port's native Blaster on the pump at full width.
    Phase A's corpus plus 5 000 `|l` keys x 32, 32 lines a datagram; an
    interning pass (flow-controlled, interval 1), then the whole corpus
    sent by the Blaster from its own thread at phase A's steady rate
    while the smoke flushes once a second: every line received and
    applied, every counter's total over the flushes equal to what was
    sent; then an unpaced pass of PHASE_U_UNPACED_S: datagrams sent,
    received, `ingest.kernel_drops` and lines/s, with received + drops
    == sent where the host's /proc/net/udp counts the drops."""
    from veneur_tpu_torch import native
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    lines, expect, _timers, _ll = _corpus(PHASE_U_SEED, PHASE_A_KEYS,
                                          PHASE_U_LL_KEYS)
    lines, dgrams, pad = _u_datagrams(lines)
    n_lines = len(lines)
    want = {k: v for k, v in expect.items() if k.startswith("smoke.c")}
    if pad:
        want["smoke.upad"] = float(pad)
    sink = ChannelMetricSink()
    server = _server({}, {"counter_capacity": 65536,
                          "gauge_capacity": 32768, "histo_capacity": 32768,
                          "set_capacity": 16384, "llhist_capacity": 8192},
                     sink)
    _zero_launches()
    server.start()
    report = {"datagrams": len(dgrams), "lines": n_lines}
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    blaster = native.Blaster(dgrams)
    try:
        addr = server.local_addr("udp")
        sock.connect(addr)
        # interval 1: every key interned on the slow path, flow-controlled
        t0 = time.perf_counter()
        _send(server, addr, lines, 0, _pump_window(server))
        report["intern_s"] = time.perf_counter() - t0
        server.flush()
        totals: dict = {}
        _u_counter_totals(sink, totals)
        if totals != want:
            raise AssertionError("phase U: the interning interval's "
                                 "counters differ from what was sent")
        # the paced pass: the Blaster alone, the smoke flushing each second
        base = server.stats_snapshot()["lines_received"]
        pps = PHASE_U_RATE / PHASE_U_PER_DGRAM
        thread, out = _u_blast(blaster, sock.fileno(),
                               max_dgrams=len(dgrams), burst=64,
                               pace_pps=pps)
        totals, flushes = {}, []
        while thread.is_alive():
            t_flush = time.perf_counter()
            server.flush()
            flushes.append(time.perf_counter() - t_flush)
            _u_counter_totals(sink, totals)
            thread.join(max(0.0, PHASE_U_FLUSH_S
                            - (time.perf_counter() - t_flush)))
        if not out or isinstance(out[0], Exception) or out[0] != len(dgrams):
            raise AssertionError(f"phase U: the Blaster sent {out}, not "
                                 f"{len(dgrams)} datagrams")
        send_s = out[1]
        got = _u_settle(server, base + n_lines) - base
        server.flush()
        flushes.append(server.last_flush_timings.get("total_s"))
        _u_counter_totals(sink, totals)
        stats = server.stats_snapshot()
        report["paced"] = {
            "pace_pps": pps, "send_s": send_s,
            "lines_per_s": n_lines / send_s, "received": got,
            "flushes": len(flushes), "flush_s": flushes,
            "kernel_drops": dict(server.overload.kernel_drops.totals())}
        if (got != n_lines or stats["lines_rejected"]
                or stats["ingest_dispatch_errors"]):
            raise AssertionError(
                f"phase U: paced pass sent {n_lines} lines, received "
                f"{got}; kernel drops {report['paced']['kernel_drops']}; "
                f"{stats}")
        if totals != want:
            bad = sorted(k for k in want if totals.get(k) != want[k])
            raise AssertionError(f"phase U: {len(bad)} counter totals "
                                 f"differ from what was sent, e.g. "
                                 f"{bad[:1]}")
        report["counters_checked"] = len(want)
        # the unpaced pass: as fast as the Blaster goes, for a while,
        # while the main process sends no UDP of its own
        report["unpaced_wait_s"] = _await_main_quiet()
        mon = server.overload.kernel_drops
        probe = _u_host_counts_drops(mon)
        counted = probe["counted"]
        mon.poll()
        drops0 = sum(mon.totals().values())
        base = server.stats_snapshot()["lines_received"]
        blaster.reset()
        thread, out = _u_blast(blaster, sock.fileno(), burst=64)
        time.sleep(PHASE_U_UNPACED_S)
        blaster.stop()
        thread.join(60.0)
        if thread.is_alive() or not out or isinstance(out[0], Exception):
            raise AssertionError(f"phase U: the unpaced Blaster {out}")
        sent, send_s = out
        got_lines = _u_settle(server, base + sent * PHASE_U_PER_DGRAM) - base
        mon.poll()
        drops = sum(mon.totals().values()) - drops0
        server.flush()
        sink.drain()
        received = got_lines // PHASE_U_PER_DGRAM
        report["unpaced"] = {
            "seconds": send_s, "sent": sent, "received": received,
            "kernel_drops": drops, "drops_counted": counted,
            "drop_probe": probe,
            "lines_per_s_sent": sent * PHASE_U_PER_DGRAM / send_s,
            "lines_per_s_received": got_lines / send_s,
            "stalls": sum(lst.pump.stalls() for lst in server._listeners
                          if lst.pump is not None)}
        if got_lines % PHASE_U_PER_DGRAM or received > sent:
            raise AssertionError(f"phase U: unpaced {report['unpaced']}")
        if counted and received + drops != sent:
            raise AssertionError(f"phase U: unpaced received + kernel "
                                 f"drops != sent: {report['unpaced']}")
    finally:
        sock.close()
        blaster.close()
        server.shutdown()
    report["launches"] = _read_launches()
    _m_require(report["launches"], _M_KERNELS, "U")
    return report


def _phase_z() -> dict:
    """Phase Z: the crash-replay SIGKILL soak on cuda:0
    (veneur_tpu_torch/cmd/crash_replay_soak.py), PHASE_Z_KILLS kills at
    the script's own shape: a WAL-on local killed with its interval on
    disk and its send unacknowledged, restarted, replayed; the faulted
    global's counters equal to the control's, its llhist registers bit
    for bit, the WAL drained, both children's and both globals' strict
    ledgers balanced. The children launch K3 in their own processes and
    report their counts."""
    from veneur_tpu_torch.cmd import crash_replay_soak
    _zero_launches()
    report = crash_replay_soak.run_soak(kills=PHASE_Z_KILLS,
                                        device="cuda:0")
    here = _read_launches()
    if (report["kills"], report["restarts"]) != (PHASE_Z_KILLS,) * 2 \
            or not report["counters"] or not report["llhist"]:
        raise AssertionError(f"phase Z: soak report {report}")
    report["launches"] = {k: here[k] + report["launches"][k]
                          for k in _M_KERNELS}
    _m_require(report["launches"], ("llhist_apply",), "Z")
    return report


def _phase_t() -> dict:
    """Phase T: the ring-failover soak at test_driver_soak's shape
    (veneur_tpu_torch/cmd/ring_failover_soak.py): a proxy over three
    capture globals, global 0 killed at round 4 and restored on its port
    at round 10, probes every 50 ms; every metric accounted for, an
    ejection and a readmission. No device code: its place is the card
    host's sockets."""
    from veneur_tpu_torch.cmd import ring_failover_soak
    report = ring_failover_soak.run_soak(**PHASE_T)
    events = {e["event"] for e in report["events"]}
    if report["loss_unaccounted"] or not report["settled"] or not (
            {"ejected", "readmitted"} <= events) or not any(
            e["event"] == "ejected" and e["confirmed"]
            for e in report["events"]):
        raise AssertionError(f"phase T: soak report {report}")
    report["launches"] = {k: 0 for k in _M_KERNELS}
    return report


def _phase_n() -> dict:
    """Phase N: the self-contained alert drill on cuda:0
    (veneur_tpu_torch/cmd/alert_drill.py): a p99 rule walked pending ->
    firing -> resolved through UDP and HTTP, the trail's three
    assertions; each alert round's capture launches K1."""
    import contextlib
    import io
    from veneur_tpu_torch.cmd import alert_drill
    _zero_launches()
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = alert_drill.main(["-device", "cuda:0"])
    report = {"rc": rc, "drill_s": time.perf_counter() - t0,
              "trail": text.getvalue().strip().splitlines()}
    if rc != 0:
        raise AssertionError(f"phase N: the drill exited {rc}: "
                             f"{report['trail']}")
    report["launches"] = _read_launches()
    _m_require(report["launches"], ("tdigest_flush",), "N")
    return report


def _prebuild_plan() -> dict:
    """Per phase, the corpora it builds first, called exactly as the
    phase calls them (the key is the arguments' repr)."""
    a, sets = PHASE_A_KEYS, (PHASE_A_KEYS["set"], PHASE_A_KEYS["set_members"])

    def with_sets(seeds, *extra):
        return [item for seed in seeds for item in (
            (_corpus, (seed, a) + extra), (_set_reference, (seed,) + sets))]
    return {
        "A": with_sets((1, 2)),
        "B": [(_phase_b_corpus, (seed,)) for seed in (3, 4)],
        "D": [(_phase_d_interval, (seed,)) for seed in PHASE_D_SEEDS],
        "F": with_sets(PHASE_F_SEEDS, PHASE_F_LL_KEYS),
        "G": with_sets((31, 32), PHASE_F_LL_KEYS),
        "H": [(_phase_d_interval, (seed,)) for seed in PHASE_H1_SEEDS],
        "I": [(_i1_corpus, (seed,)) for seed in PHASE_I1_SEEDS],
        "J": [(_corpus, (seed, a, PHASE_J_LL_KEYS)) for seed in (41, 42)],
        "O": with_sets((31, 32), PHASE_O_LL_KEYS),
        "P": with_sets(PHASE_P_SEEDS, PHASE_P_LL_KEYS),
        "M": [(_m1_interval, (seed,)) for seed in PHASE_M_SEEDS]
        + [(_m2_interval, (seed,)) for seed in PHASE_M2_SEEDS],
        "R": [(_m1_interval, (seed,)) for seed in PHASE_R1_SEEDS]
        + [(_corpus, (seed, a)) for seed in PHASE_R2_SEEDS],
        "X": [(_m1_interval, (seed,)) for seed in PHASE_X_SEEDS],
        "Y": [(_m1_interval, (seed,)) for seed in PHASE_X_SEEDS],
    }


def _start_prebuild(selected, side=()):
    """Two worker processes (spawned: the card is never forked) build the
    selected phases' big corpora, in phase order, while the kernels build
    and the earlier phases run; returns the pool to shut down. The side
    process's phases build their own."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    plan = _prebuild_plan()
    for name in PHASES:
        if name in selected and name not in side:
            for fn, args in plan.get(name, ()):
                _PREBUILT.setdefault((fn.__name__, repr(args)), []).append(
                    pool.submit(fn, *args))
    return pool


PHASES = ("A", "B", "C", "D", "E", "F", "F2", "G", "H", "I", "J", "S", "O",
          "P", "M", "R", "X", "W", "U", "Z", "T", "N", "Y")
# phases run only when named: Y needs four cards
NAMED_ONLY = ("Y",)
# phases run in a process of their own, on the same card, beside the
# main process's phases from SIDE_START on when the run has others: each
# spends most of its time on one interpreter lock (the SSF reader, the
# overload plane's senders, the OTLP and churn slow paths) or waits on
# child processes (the soaks), so the two processes share the host's
# cores instead of taking turns; J is here so that both end together
SIDE_PHASES = ("I", "J", "S", "W", "Z", "T", "N", "U")
# the main phase where the side process starts (or the first selected one
# after it)
SIDE_START = "C"

_SIDE = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
cs._IN_SIDE = True
from veneur_tpu_torch import native
from veneur_tpu_torch.ops import _cuda
_cuda.build_all()
native.load()
out = {}
for name in sys.argv[1].split(","):
    t0 = time.perf_counter()
    out[name] = cs._PHASE_RUNS[name][0]()
    out[name]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
print(json.dumps(out), flush=True)
"""


def _side_phases(selected) -> tuple:
    """The selected side phases, when the run also has a main phase."""
    side = tuple(n for n in SIDE_PHASES if n in selected)
    return side if set(selected) - set(SIDE_PHASES) else ()


def _start_side(names):
    """The side process: runs `names` in turn and prints their reports as
    one JSON line (its other output goes to the same stderr). It leads a
    process group of its own, which _kill_group stops with whatever its
    phases started. Its standard input stays open until _main_quiet."""
    return subprocess.Popen([sys.executable, "-c", _SIDE, ",".join(names)],
                            cwd=ROOT, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True,
                            start_new_session=True)


def _main_quiet(proc) -> None:
    """In the main process: tell the side process (if any) that the main
    one sends no more UDP, by closing its standard input (once)."""
    if proc is not None and proc.stdin is not None:
        proc.stdin.close()
        proc.stdin = None


def _kill_group(proc) -> None:
    """SIGKILL the process group that `proc` leads (its children too,
    which may hold its pipes or outlive it) and reap `proc`."""
    import signal
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass  # the group has ended
    proc.communicate(timeout=60)


def _finish_side(proc, names, timeout: float = 1100.0) -> dict:
    """Wait for the side process and return its phase reports; its failure
    is the run's."""
    out, _ = proc.communicate(timeout=timeout)
    lines = out.strip().splitlines()
    if proc.returncode != 0 or not lines:
        print(out[-6000:], file=sys.stderr, flush=True)
        raise AssertionError(f"side phases {names} failed (exit "
                             f"{proc.returncode})")
    for line in lines[:-1]:
        print(line, flush=True)
    return json.loads(lines[-1])


def _selected_phases(argv) -> tuple:
    """The server phases to run: `--phases S,J` or the CHIP_SMOKE_PHASES
    variable; every phase but the named-only ones (Y, four cards) when
    neither is given. The kernel checks always run."""
    import argparse
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--phases", default=os.environ.get(
        "CHIP_SMOKE_PHASES", ""), help="comma-separated phases of "
        + ",".join(PHASES) + " (default: all)")
    args = ap.parse_args(argv)
    chosen = tuple(p.strip().upper() for p in args.phases.split(",")
                   if p.strip())
    unknown = sorted(set(chosen) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    return chosen or tuple(p for p in PHASES if p not in NAMED_ONLY)


def _report_abc(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase A, B or C."""
    for i, rec in enumerate(rep["intervals"]):
        print(f"phase {name} interval {i}: {rec['lines']} lines at "
              f"{rec['lines_per_s']:.0f} lines/s, flush "
              f"{rec['flush']['total_s']:.3f} s (llhist bins "
              f"{rec['flush']['llhist_bins_s']:.3f} s), "
              f"{rec['series_checked']} series checked, K3 launches "
              f"{rec['launches']['llhist_apply']}", flush=True)
    print(f"phase {name} launches: {rep['launches']}", flush=True)


def _report_d(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase D, the forward tier."""
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


def _report_e(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase E, forward resilience."""
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


def _report_f(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase F, the sink plane."""
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


def _report_f2(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase F2, the thread plane."""
    for i, rec in enumerate(rep["flushes"]):
        print(f"phase F2 flush {i + 1}: total {rec['total_s']:.3f} s, sinks "
              f"{rec['sinks_s']:.3f} s; " + ", ".join(
                  f"{name} {r['status']}" for name, r in
                  rec["records"].items()), flush=True)
    print(f"phase F2: blocking sink's breaker {rep['breaker']}, counts "
          f"{rep['flushes'][-1]['counts']}, datadog series per interval "
          f"{rep['datadog_series_per_interval']}; launches "
          f"{rep['launches']}", flush=True)


def _report_g(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase G, the operator surface."""
    for i, rec in enumerate(rep["intervals"]):
        g_flush = rec["flush"]
        beside_f = ""
        if "F" in phases and i < len(phases["F"]["intervals"]):
            # phase F's corpus, four sinks
            f_rec = phases["F"]["intervals"][i]
            f_flush = f_rec["flush"]
            beside_f = (
                f" (phase F {f_rec['lines_per_s']:.0f} lines/s, total_s "
                f"{f_flush['total_s']:.3f}, before the sinks "
                f"{f_flush['total_s'] - f_flush['sinks_s']:.3f})")
        print(f"phase G interval {i}: {rec['lines']} lines at "
              f"{rec['lines_per_s']:.0f} lines/s, flush wall "
              f"{rec['flush_wall_s']:.3f} s, total_s "
              f"{g_flush['total_s']:.3f}, before the sinks "
              f"{g_flush['total_s'] - g_flush['sinks_s']:.3f} s"
              f"{beside_f}, readout lock wait "
              f"{g_flush.get('readout_lock_wait_s', 0.0):.4f} s; "
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


def _report_h(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase H, the proxy tier."""
    for part in ("H1", "H2"):
        for i, rec in enumerate(rep[part]["intervals"]):
            label = f"phase {part} interval {rec.get('interval', i + 1)}"
            for j, flush in enumerate(rec["local_flush"]):
                print(f"{label} local {j}: {rec['lines'][j]} lines in "
                      f"{rec['ingest_s'][j]:.2f} s, flush "
                      f"{flush['total_s']:.3f} s (forward encode "
                      f"{flush.get('forward_encode_s', 0.0):.3f}, forward "
                      f"{flush.get('forward_s', 0.0):.3f})", flush=True)
            p = rec["proxy"]
            print(f"{label} proxy: received {p['received']:.0f}, routed "
                  f"{p['routed']:.0f}, dropped {p['dest_dropped']:.0f}, "
                  f"no destination {p['no_destination']:.0f}; RPC s "
                  + ", ".join(f"{k} {v:.3f}" for k, v in
                              sorted(rec["proxy_rpc_s"].items()))
                  + "; send s " + ", ".join(
                      f"{k} {v:.3f}" for k, v in
                      sorted(rec["dest_send_s"].items()))
                  + f"; drain wait {rec['proxy_drain_s']:.3f} s",
                  flush=True)
            for j, (g, merge) in enumerate(zip(rec["global_flush"],
                                               rec["merge_s"])):
                print(f"{label} global {'AB'[j]}: {rec['imported'][j]} "
                      f"metrics imported, {rec['keys_per_global'][j]} keys "
                      f"flushed; merge s " + ", ".join(
                          f"{k} {v:.3f}" for k, v in merge.items())
                      + f"; flush {g['total_s']:.3f} s", flush=True)
        print(f"phase {part}: ledger intervals closed "
              f"{rep[part]['ledger_intervals']}", flush=True)
    print(f"phase H2: accounting {rep['H2']['accounting']}, events "
          f"{rep['H2']['events']}; phase H launches {rep['launches']}; "
          f"{rep['seconds']:.1f} s", flush=True)


def _report_i(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase I, the SSF plane."""
    for i, rec in enumerate(rep["I1"]["intervals"]):
        flush = rec["flush"]
        print(f"phase I1 interval {i + 1}: {rec['datagrams']} SSF datagrams "
              f"({rec['samples']} samples) in {rec['ingest_s']:.2f} s, "
              f"{rec['spans_per_s']:.0f} spans/s, {rec['samples_per_s']:.0f} "
              f"samples/s; flush {flush['total_s']:.3f} s (dispatch "
              f"{flush['dispatch_s']:.4f}, device sync "
              f"{flush['device_sync_s']:.4f}, assembly "
              f"{flush['assembly_s']:.3f}, sinks {flush['sinks_s']:.3f}); "
              f"{rec['series_checked']} series checked; launches "
              f"{rec['launches']}", flush=True)
    for i, rec in enumerate(rep["I2"]["intervals"]):
        flush = rec["flush"]
        print(f"phase I2 interval {i + 1}: {rec['spans']} spans delivered to "
              f"3 sinks in {rec['delivered_s']:.2f} s ({rec['spans_per_s']:.0f}"
              f" spans/s; UDP send {rec['udp_send_s']:.2f} s), span workers "
              f"{rec['span_worker_s']:.2f} s; flush {flush['total_s']:.3f} s "
              f"(sinks {flush['sinks_s']:.3f}; datadog "
              f"{flush['span_sink:datadog']['duration_s']:.3f}, kafka "
              f"{flush['span_sink:kafka']['duration_s']:.3f}); datadog "
              f"{rec['datadog_body_bytes']} bytes in {rec['datadog_bodies']} "
              f"PUTs, kafka {rec['kafka_records']} records; "
              f"{rec['series_checked']} series checked", flush=True)
    for i, rec in enumerate(rep["I3"]["intervals"]):
        print(f"phase I3 interval {i + 1}: TCP {rec['tcp_lines']} lines, UNIX "
              f"{rec['unix_lines']} lines (sent in {rec['unix_send_s']:.2f} "
              f"s), gRPC {rec['grpc_lines']} lines + {rec['grpc_spans']} "
              f"spans in {rec['grpc_s']:.2f} s; all in {rec['ingest_s']:.2f} "
              f"s; emit runs s {rec['emit_s']}; flush "
              f"{rec['flush']['total_s']:.3f} s; {rec['series_checked']} "
              f"series checked; launches {rec['launches']}", flush=True)
    print(f"phase I launches: {rep['launches']} (I1 "
          f"{rep['I1']['launches']}, I2 {rep['I2']['launches']}, I3 "
          f"{rep['I3']['launches']}); {rep['seconds']:.1f} s", flush=True)


def _report_j(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase J, the overload and self-trace planes."""
    for i, rec in enumerate(rep["J1"]["intervals"]):
        print(f"phase J1 interval {i + 1}: {rec['lines']} lines at "
              f"{rec['lines_per_s']:.0f} lines/s under a "
              f"{PHASE_J_RATE} samples/s limit; admitted "
              f"{rec['admitted']:.0f}, shed {rec['shed']}; histogram kept "
              f"{rec['histogram_kept']}, set kept {rec['set_kept']}; flush "
              f"{rec['flush']['total_s']:.3f} s; K3 launches "
              f"{rec['launches']['llhist_apply']}", flush=True)
    print(f"phase J1: kernel_drops_visible "
          f"{rep['J1']['kernel_drops_visible']}, max heartbeat age s "
          f"{rep['J1']['max_heartbeat_age_s']}, pump stall probes "
          f"{rep['J1']['pump_stall_probes']}; {rep['J1']['seconds']:.1f} s",
          flush=True)
    for i, rec in enumerate(rep["J2"]["intervals"]):
        print(f"phase J2 interval {i + 1} ({rec['state']}): {rec['lines']} "
              f"lines at {rec['lines_per_s']:.0f} lines/s; shed "
              f"{ {k: v for k, v in rec['shed'].items() if v} }; flush "
              f"{rec['flush']['total_s']:.3f} s; "
              f"{rec['series_checked']} series checked; K3 launches "
              f"{rec['launches']['llhist_apply']}"
              + (f", {rec['k3_strided_calls']} strided applies recorded"
                 if "k3_strided_calls" in rec else "")
              + (f"; ready {rec['ready'][:2]}" if "ready" in rec else ""),
              flush=True)
    print(f"phase J2: RSS after start {rep['J2']['rss_after_start']} bytes, "
          f"transitions {rep['J2']['events']}; {rep['J2']['seconds']:.1f} s",
          flush=True)
    print(f"phase J3: mangle {rep['J3']['mangle']['faults']}, "
          f"{rep['J3']['mangle']['reached_parser']} of "
          f"{rep['J3']['mangle']['datagrams']} datagrams reached the "
          f"parser; leak drill {rep['J3']['leak']['leaked']} samples, "
          f"ledger imbalance {rep['J3']['leak']['imbalance']}; "
          f"{rep['J3']['seconds']:.1f} s", flush=True)
    for i, rec in enumerate(rep["J4"]["intervals"]):
        print(f"phase J4 interval {i + 1}: traces " + "; ".join(
            f"{t['trace_id']} {t['spans']} spans, {t['merges']} merges, "
            f"{t['services']}" for t in rec["traces"])
            + f"; {rec['exemplar_lines']} exemplar lines; "
            f"{rec['series_checked']} series checked", flush=True)
    print(f"phase J4: self-spans at the span sinks local1 "
          f"{rep['J4']['local1_self_spans']}, local2 "
          f"{rep['J4']['local2_self_spans']}, global "
          f"{rep['J4']['global_self_spans']}; {rep['J4']['seconds']:.1f} s",
          flush=True)
    print(f"phase J5 ({smi}): flush total_s " + ", ".join(
        f"rate {f['sample_rate']:g} {f['total_s']:.4f}"
        for f in rep["J5"]["flushes"]), flush=True)
    print(f"phase J launches: {rep['launches']}; {rep['seconds']:.1f} s",
          flush=True)


def _report_s(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase S, the pull sources and the table lifecycle."""
    for i, rec in enumerate(rep["S1"]["intervals"]):
        flush = rec["flush"]
        print(f"phase S1 push {i + 1}: {rec['points']} OTLP points in "
              f"{rec['requests']} requests in {rec['ingest_s']:.2f} s "
              f"({rec['points_per_s']:.0f} points/s, "
              f"{rec['llhist_samples']} llhist samples); flush "
              f"{flush['total_s']:.3f} s; {rec['series_checked']} series "
              f"checked; K3 launches "
              f"{rec['launches']['llhist_apply']}", flush=True)
    s2, prom = rep["S2"]["S2"], rep["S2"]["prometheus"]
    print(f"phase S2: {s2['scrapes']} scrapes of {s2['lines_per_scrape']}"
          f" lines ({s2['gets']} GETs), flushes s {s2['flush_s']}, "
          f"{s2['series_checked']} series checked; veneur-prometheus "
          f"{prom['sent']} in {prom['run_s']:.2f} s, "
          f"{prom['series_checked']} series checked; "
          f"{rep['S2']['seconds']:.1f} s", flush=True)
    for i, rec in enumerate(rep["S3"]["intervals"]):
        tables = rec["tables"]
        print(f"phase S3 interval {i + 1}: {rec['lines']} lines at "
              f"{rec['lines_per_s']:.0f} lines/s; flush "
              f"{rec['flush']['total_s']:.3f} s; "
              f"{rec['series_checked']} series checked, unique "
              f"{rec['unique_timeseries']:.0f}; new keys on recycled rows "
              f"{rec['on_recycled_rows']}; capacity/rows "
              + ", ".join(f"{f} {t['capacity']}/{t['rows']}"
                          for f, t in tables.items())
              + f"; intern {rec['intern_table_size']} <= live "
              f"{rec['live_rows']}; launches {rec['launches']}"
              + (f"; device bytes {rec['device_bytes']}"
                 if "device_bytes" in rec else ""), flush=True)
    s4 = rep["S4"]
    print(f"phase S4: {s4['series_checked']} series checked, "
          f"keys_dropped {s4['keys_dropped']}, ledger agg.rejected "
          f"{s4['agg_rejected']}; launches {s4['launches']}", flush=True)
    print(f"phase S launches: {rep['launches']}; S1 "
          f"{rep['S1']['seconds']:.1f} s, S2 {rep['S2']['seconds']:.1f} "
          f"s, S3 {rep['S3']['seconds']:.1f} s, S4 "
          f"{rep['S4']['seconds']:.1f} s; {rep['seconds']:.1f} s",
          flush=True)


def _report_o(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase O, the overlapped flush and the cardinality rung."""
    o1, o2 = rep["O1"], rep["O2"]
    for i, rec in enumerate(o1["intervals"]):
        print(f"phase O1 interval {i + 1}: {rec['lines']} lines at "
              f"{rec['lines_per_s']:.0f} lines/s; {rec['series_checked']} "
              f"series checked", flush=True)
    print(f"phase O1 ({smi}): ticks " + "; ".join(
        ", ".join(f"{k} {v:.4f}" for k, v in tick.items())
        for tick in o1["ticks"]) + f"; tick 2 critical path "
        f"{o1['critical_path_s']:.4f} s, readout 1 "
        f"{o1['readout1_s']:.4f} s on the executor, started "
        f"{o1['readout1_start_after_tick1_s']:.4f} s into tick 1, done by "
        f"the end of interval 2's send: {o1['readout1_done_by_send_end']}; "
        f"in-flight rows {o1['swapped_rows']}; {o1['seconds']:.1f} s",
        flush=True)
    print(f"phase O1 /debug/latency: dogstatsd sample age at shutdown "
          f"{o1['latency']['sample_age']}; queue dwell at tick 2 (s) "
          + "; ".join(f"{q} depth {v['depth']} n {v['count']} p50 "
                      f"{v['p50']} p99 {v['p99']}"
                      for q, v in o1["latency_tick2"]["queues"].items()),
          flush=True)
    for i, rec in enumerate(o2["prewarmed"]["intervals"]):
        print(f"phase O2 interval {i + 1}: {rec['lines']} lines at "
              f"{rec['lines_per_s']:.0f} lines/s; storm series "
              f"{rec['storm_series']}, kept {rec['kept']}, shed "
              f"{rec['shed']}; flush {rec['flush_s']:.3f} s ("
              + ", ".join(f"{k} {v:.3f}" for k, v in rec["flush"].items())
              + f"); {rec['series_checked']} series checked; pod estimate "
              f"{rec['pod_estimate']} of {rec['pod_truth']}; top "
              f"{rec['top']}", flush=True)
    for label in ("prewarmed", "cold"):
        run = o2[label]
        print(f"phase O2 {label} ({smi}): llhist {run['resize_total']} "
              f"resize to {run['capacity']} in {run['resize_s']:.6f} s, "
              f"first apply after it {run['first_apply_s']:.6f} s; "
              f"launches {run['launches']}", flush=True)
    print(f"phase O2 mint gate alone (host): {o2['gate']}; O2 "
          f"{o2['seconds']:.1f} s (prewarmed server {o2['prewarmed_s']:.1f},"
          f" cold {o2['cold_s']:.1f})", flush=True)
    print(f"phase O launches: {rep['launches']}; {rep['seconds']:.1f} s",
          flush=True)


def _report_p(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase P: the device plane, the profiles, the handoff."""
    p1, p3 = rep["P1"], rep["P3"]
    for i, rec in enumerate(p1["intervals"]):
        print(f"phase P1 interval {i + 1}: {rec['lines']} lines at "
              f"{rec['lines_per_s']:.0f} lines/s, flush {rec['flush_s']:.3f}"
              f" s; {rec['series_checked']} series checked", flush=True)
    for snap in p1["ledger"]:
        print(f"phase P1 ledger at {snap['at']} ({smi}): total "
              f"{snap['total']} bytes, allocator allocated "
              f"{snap['allocated']}, reserved {snap['reserved']}; "
              + "; ".join(f"{f} " + ", ".join(f"{s} {n}" for s, n in
                                              st.items())
                          for f, st in snap["by_family"].items()),
              flush=True)
    rung = p1["rung"]
    print(f"phase P1 device rung: before the llhist doubling "
          f"{rung['before']} bytes, after {rung['after']} (+{rung['live']},"
          f" capacity {rung['capacity']}), soft {rung['soft']} -> "
          f"{rung['state']}; after the recycle {rung['after_recycle']} -> "
          f"{rung['state_after_recycle']}; after flush 4 "
          f"{rung['after_flush4']} -> {rung['state_after_flush4']}; "
          f"shed {rung['shed']}, kept {rung['kept']} of {rung['soft_sent']};"
          f" events {rung['events']}; /metrics {rung['prom']}", flush=True)
    print(f"phase P1 prewarm rung {p1['prewarm']}; ledger checks "
          f"{p1['conservation_checks']}; registry launches "
          f"{p1['registry_launches']} = wrappers' {p1['launches']}; "
          f"registry {p1['registry']}; /debug/device "
          f"{p1['device_report']}", flush=True)
    cost = p1["observatory_cost"]
    print(f"phase P1 observatory cost on the host ({smi}): "
          f"{cost['hook_us']:.3f} us a registry hook (bare call "
          f"{cost['bare_us']:.3f} us), {cost['retag_us']:.3f} us a ledger "
          f"retag; {cost['hooks']} hooks over four intervals: "
          f"{cost['seconds']:.6f} s, {100 * cost['share_of_flush_wall']:.5f}"
          f" % of the flushes' wall time", flush=True)
    print(f"phase P2 pprof ({smi}): {p1['pprof']}", flush=True)
    trace = p1["device_trace"]
    if trace["status"] == 200:
        print(f"phase P2 device trace ({smi}): {trace['device_events']} "
              f"device events, {trace['zip_bytes']} zip bytes; per kernel "
              + "; ".join(f"{k} {v['events']} events {v['device_ms']:.4f} ms"
                          for k, v in trace["kernels"].items())
              + f"; flush window {trace['flush_window_ms']:.3f} ms with "
              f"{trace['flush_device_events']} device events, device "
              f"busy {trace['busy_ms']:.3f} ms, busy share "
              f"{trace['busy_share']:.6f}; top 5 {trace['top5']}",
              flush=True)
    else:
        print(f"phase P2 device trace ({smi}): 503, {trace['reason']}",
              flush=True)
    print(f"phase P3 SIGUSR2 handoff ({smi}): sent {p3['sent']}, received "
          f"{p3['received']}, delivered {p3['delivered']}, sent - received "
          f"{p3['lost']} ({100 * p3['lost_share']:.4f} %); {p3['probes']} "
          f"connect probes, {p3['refused']} refused, other errors "
          f"{p3['probe_errors']}; replacement ready "
          f"{p3['ready_s']:.2f} s after the signal, old exited "
          f"{p3['old_exit_s']:.2f} s after; CLI ready wait "
          f"{p3['startup_wait_s']:.2f} s; flushes past the interval "
          f"{p3['sink_timeouts']}, sink deliveries skipped "
          f"{p3['sink_skips']}; deliveries (s after the signal, count) "
          f"{p3['posts']}; P1 {p1['seconds']:.1f} s, P3 "
          f"{p3['seconds']:.1f} s", flush=True)


def _report_m(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase M: the sharded store against a single one, and the
    sharded local and global."""
    m1, m2 = rep["M1"], rep["M2"]
    for i, rec in enumerate(m1["intervals"]):
        timing = ("merge ms per family " + ", ".join(
            f"{f} {ms:.4f}" for f, ms in rec["merge_ms"].items())
            if "merge_ms" in rec else
            "flush under the profiler: sharded " + ", ".join(
                f"{k} {rec['busy'][k]}" for k in rec["busy"])
            + "; single " + ", ".join(
                f"{k} {rec['single_busy'][k]}" for k in rec["single_busy"]))
        print(f"phase M1 interval {i + 1} ({smi}): sharded feed "
              f"{rec['feed_s']:.3f} s, single feed "
              f"{rec['single_feed_s']:.3f} s; {timing}"
              + f"; launches {rec['launches']}; {rec['series_checked']} "
              f"series equal; routed per shard {rec['routed_per_shard']}",
              flush=True)
    print(f"phase M1: {m1['ledger_checks']} ledger checks equal to the "
          f"tensors, ledger {m1['ledger_bytes']} bytes; rows per shard "
          f"{m1['rows_per_shard']}, skew {m1['skew']}; sharded path "
          f"launches {m1['launches']}; {m1['seconds']:.1f} s", flush=True)
    for i, rec in enumerate(m2["intervals"]):
        print(f"phase M2 interval {i + 1} ({smi}): {rec['lines']} lines at "
              f"{rec['lines'] / rec['ingest_s']:.0f} lines/s, local flush "
              f"{rec['local_flush']['total_s']:.3f} s, global flush "
              f"{rec['global_flush']['total_s']:.3f} s; launches "
              f"{rec['launches']}; global mesh.peer_shards "
              f"{rec['peer_shards']}; {rec['series_checked']} series "
              f"checked", flush=True)
    print(f"phase M2: startup mesh {m2['startup_mesh']}, global merge "
          f"rounds {m2['global_merge_rounds']}; sharded path launches "
          f"{m2['launches']}; {m2['seconds']:.1f} s", flush=True)


def _report_r(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase R: the in-process reshard and its crash replay, and
    the live reshard through POST /reshard."""
    r1, r2 = rep["R1"], rep["R2"]
    split = {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in r1["split"].items()}
    ctl = r1["controller"]
    print(f"phase R1 ({smi}): 2 -> 3 shards halfway through interval 1: "
          f"begin {r1['intervals'][0]['begin_s']:.3f} s, last_cutover_"
          f"seconds {ctl['last_cutover_seconds']:.4f}, flush lock held "
          f"{[round(s, 4) for _n, s in r1['flush_lock_holds']]} s; split "
          f"{split}; segments written {ctl['segments_written']}; HBM "
          f"ledger equal to the tensors after the cutover "
          f"({r1['hbm_after_cutover']} bytes, no reshard_capture); plane "
          f"{r1['plane']}", flush=True)
    for i, rec in enumerate(r1["intervals"]):
        print(f"phase R1 interval {i + 1}: feed {rec['feed_s']:.3f} s, "
              f"flush {rec['flush_s']:.3f} s (control "
              f"{rec['control_flush_s']:.3f} s); {rec['series_equal']} "
              f"series equal to the never-resharded control; launches "
              f"{rec['launches']}", flush=True)
    crash = r1["crash"]
    print(f"phase R1 crash replay: {crash['segments_written']} segments "
          f"durable, recover() replayed {crash['replayed']} in "
          f"{crash['replay_s']:.3f} s, then {crash['replayed_again']}; "
          f"{crash['series_equal']} series equal to the control; "
          f"{r1['ledger_intervals']} strict ledger intervals balanced; "
          f"R1 launches {r1['launches']}; {r1['seconds']:.1f} s",
          flush=True)
    cut = r2["cutover"]
    state = {k: r2["debug_reshard"][k] for k in ("state", "epoch", "shards")}
    print(f"phase R2 ({smi}): {r2['lines']} lines in {r2['rounds']} rounds "
          f"at up to {PHASE_R2_RATE} lines/s over {r2['send_s']:.1f} s; "
          f"flushes (when, flush, s) {r2['flushes']}; POST /reshard to "
          f"idle {cut['post_to_idle_s']:.3f} s, flush lock held "
          f"{[round(s, 4) for s in cut['lock_hold_s']]} s, "
          f"last_cutover_seconds {cut['last_cutover_seconds']:.4f}, "
          f"segments {cut['segments_written']}; /debug/reshard "
          f"{state}; "
          f"{r2['counters_checked']} counter totals equal to what was "
          f"sent; {r2['ledger_intervals']} strict ledger intervals "
          f"balanced; /metrics rows {r2['reshard_rows']}; launches "
          f"{r2['launches']}; {r2['seconds']:.1f} s", flush=True)


def _report_x(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase X: the multi-card path on one card and the dryrun."""
    x1, x2 = rep["X1"], rep["X2"]
    for i, rec in enumerate(x1["intervals"]):
        merge = ("; merge ms per family " + "; ".join(
            f"{store} " + ", ".join(f"{f} {ms:.4f}" for f, ms in m.items())
            for store, m in rec["merge_ms"].items())
            if "merge_ms" in rec else "")
        print(f"phase X1 interval {i + 1} ({smi}): feed s "
              + ", ".join(f"{k} {v:.3f}" for k, v in rec["feed_s"].items())
              + "; flush s " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         rec["flush_s"].items())
              + f"{merge}; K3 calls per group {rec['k3_per_group']}, "
              f"launches per card {rec['k3_per_card']}; series equal "
              f"{rec['series_equal']}; launches {rec['launches']}",
              flush=True)
    print(f"phase X1: plane {x1['plane']}; launches {x1['launches']}; "
          f"{x1['seconds']:.1f} s", flush=True)
    print(f"phase X2 ({smi}): mesh.full_step {x2['slots']} slots x "
          f"{x2['batch']} samples at {x2['keys']} keys in "
          f"{x2['step_s']:.3f} s, K1 + K2 on the merged state "
          f"{x2['readout_s']:.3f} s; counters, gauges and HLL registers "
          f"equal to the oracle, quantiles within "
          f"{x2['max_quantile_diff']:.4f} over {x2['touched']} keys; "
          f"launches {x2['launches']}; {x2['seconds']:.1f} s", flush=True)


def _report_y(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase Y: the store over four cards, and device_loss."""
    y1, y2 = rep["Y1"], rep["Y2"]
    for i, rec in enumerate(y1["intervals"]):
        print(f"phase Y1 interval {i + 1} ({smi}): feed s "
              + ", ".join(f"{k} {v:.3f}" for k, v in rec["feed_s"].items())
              + "; flush s " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         rec["flush_s"].items())
              + "; bytes copied between cards " + ", ".join(
                  f"{k} {v}" for k, v in rec["copied_bytes"].items())
              + f"; K3 launches per card {rec['k3_per_card']}; ledger by "
              f"card {rec['ledger_by_device']}; series equal "
              f"{rec['series_equal']}", flush=True)
    print(f"phase Y1: plane {y1['plane']}; launches {y1['launches']}; "
          f"{y1['seconds']:.1f} s", flush=True)
    for i, rec in enumerate(y2["intervals"]):
        loss = (f"device_loss({PHASE_Y_LOST}) {rec['device_loss_s']:.3f} s, "
                if "device_loss_s" in rec else "")
        print(f"phase Y2 interval {i + 1} ({smi}): {loss}feed "
              f"{rec['feed_s']:.3f} s, flush {rec['flush_s']:.3f} s "
              f"(control {rec['control_flush_s']:.3f} s); "
              f"{rec['series_equal']} series equal to the control; ledger "
              f"by card {rec['ledger_by_device']}; launches "
              f"{rec['launches']}", flush=True)
    ctl = y2["controller"]
    print(f"phase Y2: plane {y2['plane']}; controller epoch "
          f"{ctl['epoch']}, device_losses {ctl['device_losses']}, "
          f"last_cutover_seconds {ctl['last_cutover_seconds']:.4f}; "
          f"{y2['ledger_intervals']} strict ledger intervals balanced; "
          f"{y2['seconds']:.1f} s", flush=True)


def _report_w(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase W, the SIGKILL reshard soak."""
    print(f"phase W ({smi}): {rep['kills']} kill, {rep['restarts']} "
          f"restart on {rep['device']}; rounds (rows equal, segments "
          f"replayed, s) " + ", ".join(
              f"({r['rows']}, {r['segments']}, {r['seconds']:.2f})"
              for r in rep["rounds"]) + f"; soak {rep['seconds']:.1f} s",
          flush=True)


def _report_u(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase U, the Blaster on the pump."""
    paced, unpaced = rep["paced"], rep["unpaced"]
    probe = unpaced["drop_probe"]
    print(f"phase U ({smi}): {rep['datagrams']} datagrams of "
          f"{PHASE_U_PER_DGRAM} lines ({rep['lines']} lines), interned in "
          f"{rep['intern_s']:.2f} s; paced at {paced['pace_pps']:.1f} "
          f"datagrams/s: {paced['lines_per_s']:.0f} lines/s over "
          f"{paced['send_s']:.2f} s, {paced['flushes']} flushes, every "
          f"line received, {rep['counters_checked']} counter totals "
          f"equal, kernel drops {paced['kernel_drops']}; unpaced "
          f"{unpaced['seconds']:.2f} s (after {rep['unpaced_wait_s']:.1f} s "
          f"waiting for the main process's UDP to end): {unpaced['sent']} "
          f"datagrams sent, "
          f"{unpaced['received']} received, kernel drops "
          + (f"{unpaced['kernel_drops']} (received + drops == sent)"
             if unpaced["drops_counted"] else
             f"{unpaced['kernel_drops']}, but this host does not count "
             f"them (an unread socket lost {probe['sent'] - probe['queued']}"
             f" of {probe['sent']} datagrams, its /proc/net/udp drops "
             f"column read {probe['drops_column']}), "
             f"{unpaced['sent'] - unpaced['received']} lost uncounted")
          + f", {unpaced['lines_per_s_sent']:.0f} lines/s sent, "
          f"{unpaced['lines_per_s_received']:.0f} received, pump stalls "
          f"{unpaced['stalls']}; launches {rep['launches']}", flush=True)


def _report_z(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase Z, the crash-replay soak."""
    print(f"phase Z ({smi}): {rep['kills']} kills, {rep['restarts']} "
          f"restarts on {rep['device']}; rounds (s) " + ", ".join(
              f"{r['seconds']:.2f}" for r in rep["rounds"])
          + f"; {len(rep['counters'])} counters and "
          f"{len(rep['llhist'])} llhist rows equal to the control, "
          f"{rep['dedupe_drops']} duplicate segments dropped; launches "
          f"{rep['launches']}; soak {rep['seconds']:.1f} s", flush=True)


def _report_t(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase T, the ring-failover soak."""
    events = ", ".join(
        f"{e['event']}@{e['round']}"
        + (f" {e['seconds']:.3f} s" if "seconds" in e else "")
        for e in rep["events"])
    print(f"phase T ({smi}): {rep['sent']} sent, {rep['received']} "
          f"received, loss unaccounted {rep['loss_unaccounted']}, "
          f"detection-window loss {rep['detection_window_loss']}; "
          f"{events}; soak {rep['seconds']:.1f} s", flush=True)


def _report_n(name: str, rep: dict, phases: dict, smi: str) -> None:
    """Print phase N, the alert drill."""
    print(f"phase N ({smi}): drill exit {rep['rc']} in "
          f"{rep['drill_s']:.1f} s; {rep['trail'][-1]}; launches "
          f"{rep['launches']}", flush=True)


# each phase's run and the report it prints
_PHASE_RUNS = {
    "A": (_phase_a, _report_abc),
    "B": (_phase_b, _report_abc),
    "C": (_phase_c, _report_abc),
    "D": (_phase_d, _report_d),
    "E": (_phase_e, _report_e),
    "F": (_phase_f, _report_f),
    "F2": (_phase_f2, _report_f2),
    "G": (_phase_g, _report_g),
    "H": (_phase_h, _report_h),
    "I": (_phase_i, _report_i),
    "J": (_phase_j, _report_j),
    "S": (_phase_s, _report_s),
    "O": (_phase_o, _report_o),
    "P": (_phase_p, _report_p),
    "M": (_phase_m, _report_m),
    "R": (_phase_r, _report_r),
    "X": (_phase_x, _report_x),
    "W": (_phase_w, _report_w),
    "U": (_phase_u, _report_u),
    "Z": (_phase_z, _report_z),
    "T": (_phase_t, _report_t),
    "N": (_phase_n, _report_n),
    "Y": (_phase_y, _report_y),
}


T_START = time.perf_counter()


def main(argv=None) -> int:
    selected = _selected_phases(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "veneur_tpu_torch")):
        print("chip_smoke: veneur_tpu_torch is not beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    pool = _start_prebuild(selected, _side_phases(selected))
    try:
        return _smoke(selected)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _smoke(selected) -> int:
    """The kernel checks, the selected server phases and the report."""
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
    side_names, side = _side_phases(selected), None
    try:
        for name in PHASES:
            if name not in selected:
                continue
            if side_names and side is None and (
                    PHASES.index(name) >= PHASES.index(SIDE_START)):
                side = _start_side(side_names)
            if PHASES.index(name) >= PHASES.index(QUIET_FROM):
                _main_quiet(side)
            if name in side_names:
                continue
            run, report = _PHASE_RUNS[name]
            t0 = time.perf_counter()
            phases[name] = rep = run()
            rep["seconds"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            report(name, rep, phases, smi)
        _main_quiet(side)
        if side is not None:
            side_reports = _finish_side(side, side_names)
            for name in side_names:
                phases[name] = side_reports[name]
                _PHASE_RUNS[name][1](name, phases[name], phases, smi)
    finally:
        if side is not None:
            _kill_group(side)
    print("phase seconds: " + ", ".join(
        f"{name} {rep['seconds']:.1f}" for name, rep in phases.items())
        + (f" ({'+'.join(side_names)} in a side process)" if side_names
           else "") + f"; smoke wall {time.perf_counter() - T_START:.1f} s",
        flush=True)

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
