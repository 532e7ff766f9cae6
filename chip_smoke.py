#!/usr/bin/env python3
"""Chip smoke test of veneur_tpu_torch: builds the CUDA kernels, holds each
against its plain PyTorch version on the card, then runs the port's server
end to end on the card at the README's 100k-key scale.

    python3 chip_smoke.py

Needs one CUDA card (it exits non-zero without one, and when the package
is not beside it). Phases, each fatal on failure:

  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from veneur_tpu_torch/csrc with nvcc;
  3. each kernel against its plain version on the card at the main path's
     shapes, with its median time (CUDA events), the plain version's time
     and the least time the card could take (its bound);
  4. a Server on cuda:0 ingests ~0.88 M DogStatsD lines over loopback UDP
     (40k counter, 20k gauge, 30k timer x 16 and 10k set x 32 keys) in
     each of two intervals, flushes after each, and every series is
     checked: counters, gauges and timer min/max/count exactly, timer
     p50/p99 against the rank slack of the t-digest's k-scale, set
     estimates against the reference HLL over the same members.

It prints a `details` JSON line (every measurement, and the register
and shared-memory use ptxas reported for each kernel), a `kernels` JSON
line (with each kernel's launches counted in the server phase alone),
and last `{"ok": true, "device": {...}}`.
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
# rate outside the tensor cores, operations/s (H100 SXM: 67 TFLOP/s)
_MEM_RATE = {"H100 80GB HBM3": 3.35e12, "H100 PCIe": 2.0e12,
             "H100 NVL": 3.9e12, "H200": 4.8e12}
_F32_RATE = {"H100 80GB HBM3": 67e12, "H100 PCIe": 51e12,
             "H100 NVL": 60e12, "H200": 67e12}

PS = (0.5, 0.9, 0.99)
K1_TOL = dict(rtol=2e-5, atol=1e-4)  # tests/test_pallas.py:97
K2_RTOL = 1e-5                       # tests/test_pallas.py:24


def _rate(table: dict, card: str) -> float:
    for key, rate in table.items():
        if key in card:
            return rate
    raise RuntimeError(f"no published rate for card {card!r}")


def _time_ms(fn, reps: int, runs: int = 5) -> float:
    """Median over `runs` of the mean time of `reps` back-to-back calls,
    from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


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
    nbytes = tf.bound_bytes(num_keys, width, len(PS))
    # per slot: a cumsum add, a multiply-add for the sum, a compare for n
    # and one per percentile
    nops = num_keys * width * (4 + len(PS))
    bytes_ms = nbytes / _rate(_MEM_RATE, card) * 1e3
    ops_ms = nops / _rate(_F32_RATE, card) * 1e3
    return {"width": width, "num_keys": num_keys, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": nops}


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
    nbytes = he.bound_bytes(num_rows)
    nops = num_rows * he.M * 3  # per register: compare, power of two, add
    bytes_ms = nbytes / _rate(_MEM_RATE, card) * 1e3
    ops_ms = nops / _rate(_F32_RATE, card) * 1e3
    return {"num_rows": num_rows, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": nops}


# -- phase 4: the server end to end -----------------------------------------

COUNTER_KEYS, GAUGE_KEYS, TIMER_KEYS, SET_KEYS = 40_000, 20_000, 30_000, 10_000
TIMER_SAMPLES, SET_MEMBERS = 16, 32
DGRAM_BYTES = 1400
WINDOW_LINES = 1500  # in flight on loopback: well under the socket buffer


def _corpus(seed: int):
    """One interval's lines (shuffled) and the expected series."""
    rng = np.random.default_rng(seed)
    lines = []
    expect = {}
    cvals = rng.integers(1, 1000, COUNTER_KEYS)
    crates = rng.choice([1.0, 0.5], COUNTER_KEYS)
    for k in range(COUNTER_KEYS):
        lines.append(f"smoke.c{k}:{cvals[k]}|c|@{crates[k]}")
        expect[f"smoke.c{k}"] = float(math.trunc(cvals[k] / crates[k]))
    gtext = np.char.mod("%.3f", rng.normal(0, 100, (GAUGE_KEYS, 2)))
    for k in range(GAUGE_KEYS):
        for v in gtext[k]:
            lines.append(f"smoke.g{k}:{v}|g")
    tvals = rng.gamma(2.0, 25.0, (TIMER_KEYS, TIMER_SAMPLES))
    ttext = np.char.mod("%.3f", tvals)
    for k in range(TIMER_KEYS):
        for v in ttext[k]:
            lines.append(f"smoke.t{k}:{v}|ms")
    for k in range(SET_KEYS):
        for j in range(SET_MEMBERS):
            lines.append(f"smoke.s{k}:u{seed}-{k}-{j}|s")
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
    return lines, expect, timers


def _set_reference(seed: int) -> np.ndarray:
    from veneur_tpu_torch.ops import hll_ref
    est = np.empty(SET_KEYS)
    for k in range(SET_KEYS):
        h = hll_ref.HLL()
        for j in range(SET_MEMBERS):
            h.insert(f"u{seed}-{k}-{j}".encode())
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


def _send(server, addr, dgrams, counts, base: int) -> float:
    """Send paced by the server's received-line count, so loopback drops
    nothing; returns when every line has been received (or raises)."""
    sent = base
    t0 = time.perf_counter()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for dgram, n in zip(dgrams, counts):
            deadline = time.monotonic() + 30.0
            while sent - server.stats["lines_received"] > WINDOW_LINES:
                if time.monotonic() > deadline:
                    raise AssertionError("server stopped receiving lines")
                time.sleep(0.0005)
            tx.sendto(dgram, addr)
            sent += n
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


def _check_interval(got: dict, expect: dict, timers: np.ndarray,
                    set_ref: np.ndarray) -> dict:
    missing = [name for name in expect if name not in got]
    if missing:
        raise AssertionError(f"{len(missing)} series missing, e.g. "
                             f"{missing[:3]}")
    wrong = [(n, v, got[n]) for n, v in expect.items() if got[n] != v]
    if wrong:
        raise AssertionError(f"{len(wrong)} counter/gauge series wrong, "
                             f"e.g. {wrong[:3]}")
    n = timers.shape[1]
    t = np.arange(TIMER_KEYS)
    for suffix, want in (("min", timers[:, 0]), ("max", timers[:, -1])):
        vals = np.array([got[f"smoke.t{k}.{suffix}"] for k in t])
        if not np.array_equal(vals, want.astype(np.float64)):
            raise AssertionError(f"timer {suffix} differs")
    counts = np.array([got[f"smoke.t{k}.count"] for k in t])
    if not (counts == n).all():
        raise AssertionError("timer counts differ")
    for p, label in ((0.5, "50"), (0.99, "99")):
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
    est = np.array([got[f"smoke.s{k}"] for k in range(SET_KEYS)])
    if not np.array_equal(est, set_ref):
        raise AssertionError(
            f"set estimates differ from the reference HLL for "
            f"{int((est != set_ref).sum())} keys")
    # the reference estimator rounds floor(x + 1) (hyperloglog.go:225-231
    # parity), so allow its +1 on top of 2 %
    rel = np.abs(est - SET_MEMBERS) / SET_MEMBERS
    if not (np.abs(est - SET_MEMBERS) <= 0.02 * SET_MEMBERS + 1).all():
        raise AssertionError("set estimate beyond 2 % + 1 of the truth")
    return {"series_checked": len(expect) + TIMER_KEYS * 5 + SET_KEYS,
            "set_mean_rel_err": float(rel.mean())}


def _server_phase() -> dict:
    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.ops import hll_estimate, tdigest_flush
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    cfg = config_from_dict({
        "statsd_listen_addresses": ["udp://127.0.0.1:0"],
        "interval": "1h",  # the smoke flushes by hand
        "percentiles": list(PS), "aggregates": ["min", "max", "count"],
        "read_buffer_size_bytes": 8 << 20, "hostname": "smoke",
        "tpu": {"counter_capacity": 65536, "gauge_capacity": 32768,
                "histo_capacity": 32768, "set_capacity": 16384,
                "batch_cap": 8192}})
    corpora = [_corpus(seed) for seed in (1, 2)]
    set_refs = [_set_reference(seed) for seed in (1, 2)]
    sink = ChannelMetricSink()
    server = Server(cfg, extra_metric_sinks=[sink])  # cuda:0
    report = {"intervals": []}
    tdigest_flush.launches = 0
    hll_estimate.launches = 0
    server.start()
    try:
        addr = server.listen_addresses[0]
        base = 0
        for (lines, expect, timers), set_ref in zip(corpora, set_refs):
            dgrams, counts = _datagrams(lines)
            ingest_s = _send(server, addr, dgrams, counts, base)
            base += len(lines)
            server.flush()
            got = {m.name: m.value for m in sink.wait_flush(timeout=300)}
            checked = _check_interval(got, expect, timers, set_ref)
            report["intervals"].append({
                "lines": len(lines), "datagrams": len(dgrams),
                "ingest_s": ingest_s, "lines_per_s": len(lines) / ingest_s,
                "flush": dict(server.last_flush_timings), **checked})
    finally:
        server.shutdown()
    report["launches"] = {"tdigest_flush": tdigest_flush.launches,
                          "hll_estimate": hll_estimate.launches}
    stats = server.stats_snapshot()
    report["stats"] = stats
    if stats["lines_rejected"] or stats["llhist_rejected"]:
        raise AssertionError(f"lines rejected: {stats}")
    for name, count in report["launches"].items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched by the server")
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "veneur_tpu_torch")):
        print("chip_smoke: veneur_tpu_torch is not beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    from veneur_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    _cuda.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {[src.stem for src in _cuda.sources()]} in {build_s:.1f} s",
          flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1 = _check_k1(card, 256, gen)
    k1_128 = _check_k1(card, 128, gen)
    k2 = _check_k2(card, gen)
    torch.cuda.empty_cache()
    for label, rec in (("tdigest_flush W=256", k1),
                       ("tdigest_flush W=128", k1_128),
                       ("hll_estimate", k2)):
        print(f"{label}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.3f} "
              f"ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}), "
              f"max_abs_err {rec['max_abs_err']:.3g}", flush=True)

    server = _server_phase()
    for i, rec in enumerate(server["intervals"]):
        print(f"interval {i}: {rec['lines']} lines at "
              f"{rec['lines_per_s']:.0f} lines/s, flush "
              f"{rec['flush']['total_s']:.3f} s, "
              f"{rec['series_checked']} series checked", flush=True)

    kernels = [
        {"name": "tdigest_flush", "route": "cuda",
         "source": "veneur_tpu_torch/csrc/tdigest_flush.cu",
         "replaces": "veneur_tpu/ops/pallas_tdigest.py:82",
         "launches": server["launches"]["tdigest_flush"],
         **{k: k1[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by")},
         "library_ms": None},
        {"name": "hll_estimate", "route": "cuda",
         "source": "veneur_tpu_torch/csrc/hll_estimate.cu",
         "replaces": "veneur_tpu/ops/pallas_hll.py:51",
         "launches": server["launches"]["hll_estimate"],
         **{k: k2[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by")},
         "library_ms": None},
    ]
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln]
             for name, log in _cuda.build_logs.items()}
    print(json.dumps({"details": {
        "card": smi, "build_s": build_s, "ptxas": ptxas,
        "tdigest_flush": [k1, k1_128], "hll_estimate": k2,
        "server": server}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
