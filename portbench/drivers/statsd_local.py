"""The local tier's traffic: DogStatsD batches into
`Server.handle_packet_batch` from one closed-loop feeder, and the server's
own flush at every interval of the window, into a Datadog sink whose bodies a
loopback receiver keeps for the check.

The harness starts the metric sinks and not the server's flush loop: it
calls `Server.flush()`, the loop's body, itself, so that every run holds
the same flushes. An interval gate (common.IntervalGate) makes each batch
atomic against each swap, so the reference knows what every flush held.
"""

from __future__ import annotations

import gc
import json
import math
import threading
import time
from typing import List

from portbench import common, devtrace, seams, statsd_corpus
from portbench.judge_statsd import judge  # noqa: F401  (the cell's check)


def _server_config(config: dict, receiver_url: str) -> dict:
    raw = json.loads(json.dumps(config["server"]))
    raw.update({
        "flush_on_shutdown": False,
        "metric_sinks": [{"kind": "datadog", "name": "datadog", "config": {
            "datadog_api_key": "portbench",
            "datadog_api_hostname": receiver_url}}],
    })
    return raw


def _apply_seconds(server) -> float:
    """Host dispatch seconds of the apply kind, summed over families, in
    the device observatory's kernel registry."""
    total = 0.0
    for row in server.deviceobs.kernel_report()["kernels"]:
        if row["kind"] == "apply" and "wall" in row:
            total += float(row["wall"]["sum"])
    return total


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, t_start: float, device: str = "cuda") -> dict:
    """One run of a local cell; returns the run's record for the metric
    readers and the judge."""
    import torch
    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.core.server import Server

    rec: dict = {"seconds": seconds, "trace": trace}
    receiver = common.Receiver()
    server = None
    undo: list = []
    try:
        parts = rec["setup_parts"] = {"imports": time.perf_counter()
                                      - t_start}
        mark = time.perf_counter()

        def lap(name):
            nonlocal mark
            now = time.perf_counter()
            parts[name] = now - mark
            mark = now
        pool = statsd_corpus.build(config, traffic, seed)
        lap("traffic")
        cfg = config_from_dict(_server_config(config, receiver.url))
        server = Server(cfg, device=device)
        for sink in server.metric_sinks:
            sink.start(server)
        lap("server")
        gate = common.IntervalGate()
        launches: list = []
        undo = [seams.gate_swaps(gate), seams.note_kernels(launches)]
        spans = common.Spans(traced=False)
        n_batches = len(pool.batches)

        def feed(bid: int) -> None:
            gate.run_batch(bid, server.handle_packet_batch,
                           pool.batches[bid])

        # set-up: one pass over the pool (every key interned on the slow
        # path, every table at its working size), and one flush that
        # reads out every family at the cell's shapes
        for bid in range(n_batches):
            feed(bid)
        lap("warm_pass")
        server.flush()
        # a sink still posting the warm flush would be skipped by the
        # window's first flush
        server._join_sink_threads(time.perf_counter() + 120.0)
        receiver.cut()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        lap("warm_flush")
        apply_s0 = _apply_seconds(server)
        rec["setup_s"] = time.perf_counter() - t_start

        # the window: one closed-loop feeder, and the flush every interval
        spans.traced = trace
        tracer = devtrace.Tracer(trace and device == "cuda")
        done_at: List[float] = []
        errors: List[str] = []
        flush_timings: List[dict] = []
        tracer.start()
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def feeder():
            try:
                bid = 0
                while time.perf_counter() < t_end:
                    spans.run("ingest_batch", feed, bid)
                    done_at.append(time.perf_counter())
                    bid = (bid + 1) % n_batches
            except Exception as e:  # a failed apply ends the run's check
                errors.append(repr(e))
        thread = threading.Thread(target=feeder)
        thread.start()
        every = float(str(config["server"]["interval"]).rstrip("s"))
        for i in range(1, int(math.ceil(seconds / every))):
            wait = t0 + i * every - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            spans.run("flush", server.flush)
            flush_timings.append(dict(server.last_flush_timings))
            receiver.cut()
        thread.join()
        t_stop = time.perf_counter()
        trace_out = tracer.stop(t0, t_end, spans)
        spans.traced = False
        rec["window_s"] = t_end - t0
        if device == "cuda":
            torch.cuda.synchronize()
            rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        rec["apply_dispatch_s"] = _apply_seconds(server) - apply_s0

        # after the window: one flush takes the rest of the traffic, so
        # every batch fed reaches the check
        server.flush()
        receiver.cut()
        for fn in undo:
            fn()
        undo = []
        log = list(gate.log)
        server.shutdown()
        server = None
        groups = receiver.finish()
        flushes = gate.epoch
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        batches_in = sum(1 for t in done_at if t <= t_end)
        rec.update({
            "pool": pool, "log": log, "groups": groups,
            "flushes": flushes,
            "batches": len(done_at),
            "samples_in_window": batches_in * pool.lines_per_batch,
            "feed_errors": errors,
            "flush_timings": flush_timings,
            "ingest_batch_s": spans.durations("ingest_batch", t0, t_end),
            "launches": [x for x in launches if t0 <= x[1] <= t_end],
            "trace_out": trace_out,
            "after_s": time.perf_counter() - t_stop,
        })
        rec["attempted"] = rec["batches"] + len(flush_timings)
        rec["failed"] = len(errors)
        return rec
    finally:
        for fn in undo:
            fn()
        if server is not None:
            try:
                server.shutdown()
            except Exception:  # the run already failed; keep its error
                pass
        receiver.close()
