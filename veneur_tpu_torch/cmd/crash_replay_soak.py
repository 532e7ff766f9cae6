"""Crash/replay soak: SIGKILL a WAL-on local mid-flush, after its
interval is on disk and before the global's ack, restart it, replay the
WAL, and diff the global's final state against an unfaulted control
(torch port of scripts/crash_replay_soak.py).

What it exercises (the durable interval WAL):

- `forward_wal: true` appends every forwardable interval snapshot to
  disk (fsync'd, interval-stamped) BEFORE the send attempt;
- a `kill -9` landing between the append and the receiver's ack loses
  nothing: the restarted process re-scans the spool and replays the
  unacked interval;
- per-segment idempotency tokens (derived from the on-disk name, stable
  across restarts) make the replay exactly-once: a segment whose send
  landed but whose ack was lost is deduped, not merged twice.

The kill is made deterministic: the child local runs with
`chaos_forward_latency_ms` high enough that every forward send hangs
mid-flight, the parent waits until a fresh WAL segment is on disk (the
append happened; the flush is mid-send; a segment is written to a
`.tmp` name and renamed, so a visible one is whole), and then sends
SIGKILL. The restarted child runs with chaos off and drains the log.

The invariant is exactness: after N kill/restart rounds the faulted
global holds the same counter sums as an unfaulted control fed the same
stream, and the llhist registers match bit for bit (register adds merge
exactly in any order). `ledger_strict` is on in both children and both
globals, so a conservation break raises out of flush() and "FLUSHED"
never prints.

The children run on the parent's device and load the kernels the
parent built (ops/_cuda.py's build directory, named by source hash), so
no child compiles. Run:

    python -m veneur_tpu_torch.cmd.crash_replay_soak --kills 2 [-device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time

CHILD_ENV_FLAG = "CRASH_REPLAY_SOAK_CHILD"
KERNELS = ("tdigest_flush", "hll_estimate", "llhist_apply")
_TPU = {"counter_capacity": 128, "gauge_capacity": 128,
        "histo_capacity": 128, "set_capacity": 64, "llhist_capacity": 64,
        "batch_cap": 512}


def wait_until(pred, timeout=30.0, step=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


def _launches() -> dict:
    """Each kernel wrapper's launch count in this process."""
    from veneur_tpu_torch.ops import hll_estimate, llhist_apply, tdigest_flush
    return {"tdigest_flush": tdigest_flush.launches,
            "hll_estimate": hll_estimate.launches,
            "llhist_apply": llhist_apply.launches}


# ---------------------------------------------------------------------------
# child: one local server, WAL on, forwarding to the parent's global
# ---------------------------------------------------------------------------


def run_child() -> None:
    """Child-process entry: a local Server with the WAL on, on
    $SOAK_DEVICE, fed DogStatsD lines over stdin (one metric line per
    input line; `FLUSH` flushes and prints `FLUSHED` with this process's
    kernel launches as JSON; EOF exits after a final flush). Forward
    sends hang for $SOAK_CHAOS_MS, so the parent can SIGKILL this
    process mid-send."""
    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.core.server import Server

    raw = {
        "interval": "3600s",  # flushes are driven by the feed protocol
        "hostname": "soak-local",
        "statsd_listen_addresses": [],
        "forward_address": os.environ["SOAK_FORWARD_ADDRESS"],
        "carryover_spool_dir": os.environ["SOAK_WAL_DIR"],
        "forward_wal": True,
        "forward_retry_max_attempts": 1,
        "circuit_breaker_failure_threshold": 10_000,
        # every interval's books close with zero unexplained imbalance
        # through the kill/replay cycle: strict raises out of flush(),
        # so "FLUSHED" never prints and the soak fails
        "ledger_strict": True,
        "tpu": dict(_TPU),
    }
    chaos_ms = float(os.environ.get("SOAK_CHAOS_MS", "0"))
    if chaos_ms:
        raw["chaos_enabled"] = True
        raw["chaos_forward_latency_ms"] = chaos_ms
    server = Server(config_from_dict(raw), device=os.environ["SOAK_DEVICE"])
    # the span extraction's 1-in-100 ssf.names_unique roll would add a
    # row of the server's own flush spans to one pipeline and not the
    # other
    server.metric_extraction.uniqueness_rate = 0.0
    server.start()  # re-scans the spool a killed round left
    print("READY", flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line == "FLUSH":
            server.flush()
            print("FLUSHED " + json.dumps(_launches()), flush=True)
            continue
        server.handle_metric_packet(line.encode())
    server.store.apply_all_pending()
    server.flush()
    print("DONE", flush=True)


# ---------------------------------------------------------------------------
# parent: two in-process globals (faulted path + control), the kill loop
# ---------------------------------------------------------------------------


def _mk_global(device: str):
    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.forward.server import ImportServer
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    cfg = config_from_dict({
        "interval": "3600s", "hostname": "soak-global",
        "statsd_listen_addresses": [], "ledger_strict": True,
        "tpu": dict(_TPU)})
    obs = ChannelMetricSink()
    server = Server(cfg, device=device, extra_metric_sinks=[obs])
    server.metric_extraction.uniqueness_rate = 0.0
    imp = ImportServer(server, "127.0.0.1:0")
    imp.start()
    return server, imp


class _Child:
    """A child process and a reader thread over its stdout, so that every
    wait has a timeout even when the child hangs. `launches` holds the
    kernel launches of its last `FLUSHED` line."""

    def __init__(self, wal_dir: str, forward_address: str, chaos_ms: float,
                 device: str):
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env.update({
            CHILD_ENV_FLAG: "1",
            "PYTHONPATH": os.pathsep.join(
                p for p in (root, env.get("PYTHONPATH", "")) if p),
            "SOAK_FORWARD_ADDRESS": forward_address,
            "SOAK_WAL_DIR": wal_dir,
            "SOAK_CHAOS_MS": str(chaos_ms),
            "SOAK_DEVICE": device,
        })
        self.launches = {k: 0 for k in KERNELS}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.cmd.crash_replay_soak"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
            cwd=root, text=True, bufsize=1)
        self._lines: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()
        self.expect("READY", timeout=120.0)

    def _read(self) -> None:
        for line in self.proc.stdout:
            self._lines.put(line.strip())
        self._lines.put(None)  # EOF

    def feed(self, lines) -> None:
        for line in lines:
            self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def expect(self, prefix: str, timeout: float = 60.0) -> str:
        deadline = time.time() + timeout
        while True:
            try:
                line = self._lines.get(
                    timeout=max(0.0, deadline - time.time()))
            except queue.Empty:
                raise AssertionError(f"no {prefix!r} from the child in "
                                     f"{timeout} s") from None
            if line is None:
                raise AssertionError(f"the child exited (rc "
                                     f"{self.proc.wait()}) before "
                                     f"{prefix!r}")
            if line.startswith(prefix):
                return line

    def flush(self, lines=()) -> None:
        """Feed `lines`, flush, and wait for the flush to return."""
        self.feed(list(lines) + ["FLUSH"])
        got = self.expect("FLUSHED")
        self.launches = json.loads(got[len("FLUSHED "):])

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass
        self.proc.wait()
        for pipe in (self.proc.stdin, self.proc.stdout):
            try:
                pipe.close()
            except OSError:
                pass


def _wal_segments(wal_dir: str):
    try:
        return sorted(f for f in os.listdir(wal_dir)
                      if f.endswith(".vspool"))
    except OSError:
        return []


def lines_for(round_no: int, counters_per_round: int = 40,
              value: int = 3):
    """One round's lines. Counters carry the global-only tag so a local
    forwards them (mixed-scope counters flush locally); llhist samples
    are mixed-scope and forward their registers."""
    out = []
    for i in range(counters_per_round):
        out.append(f"soak.cnt.{i % 8}:{value}|c|#veneurglobalonly")
        out.append(f"soak.llh.{i % 4}:{(round_no * 17 + i) % 91}|l")
    return out


def counter_sums(server) -> dict:
    """The global's counter totals by name (one table-level flush)."""
    import numpy as np
    server.store.apply_all_pending()
    vals, touched, meta = server.store.counters.snapshot_and_reset()
    return {meta[row].name: float(vals[row])
            for row in np.flatnonzero(np.asarray(touched)).tolist()
            if meta[row] is not None}


def llhist_bins(server) -> dict:
    """The global's llhist registers by name (one table-level flush)."""
    import numpy as np
    _out, bins, touched, meta = server.store.llhists.snapshot_and_reset(
        ps=(0.5,))
    return {meta[row].name: np.asarray(bins)[i]
            for i, row in enumerate(np.flatnonzero(
                np.asarray(touched)).tolist())
            if meta[row] is not None}


def _prepare(device: str) -> None:
    """Build the native library, and on a card the kernels, in this
    process, so that no child compiles (they find them by hash)."""
    from veneur_tpu_torch import native
    native.build()
    if device.startswith("cuda"):
        from veneur_tpu_torch.ops import _cuda
        _cuda.build_all()


def run_soak(kills: int = 3, counters_per_round: int = 40, value: int = 3,
             chaos_ms: float = 20_000.0, device: str = "cuda:0",
             verbose: bool = False) -> dict:
    """`kills` rounds of feed -> flush -> SIGKILL mid-send -> restart ->
    replay, then a clean final round, the globals and the children on
    `device`. Returns the report (the control's counter sums and nonzero
    llhist registers, each round's seconds, the children's kernel
    launches); raises AssertionError when an invariant breaks."""
    import numpy as np

    _prepare(device)
    t0 = time.perf_counter()
    faulted, f_imp = _mk_global(device)
    control, c_imp = _mk_global(device)
    tmp = tempfile.mkdtemp(prefix="crash-replay-soak-")
    wal_dir = os.path.join(tmp, "wal")
    report = {"kills": 0, "restarts": 0, "rounds": [], "device": device}
    launches = {k: 0 for k in KERNELS}

    def retire(proc) -> None:
        proc.kill()
        for k in KERNELS:
            launches[k] += proc.launches[k]

    child = None
    ctl = _Child(os.path.join(tmp, "wal-control"), c_imp.address, 0.0,
                 device)
    try:
        for round_no in range(kills):
            t_round = time.perf_counter()
            if child is not None:
                # the previous round's replay child ran chaos-free (its
                # WAL is drained); each kill round needs the hang seam
                # back, so respawn with chaos on
                retire(child)
            child = _Child(wal_dir, f_imp.address, chaos_ms, device)
            lines = lines_for(round_no, counters_per_round, value)
            child.feed(lines)
            ctl.flush(lines)
            before = set(_wal_segments(wal_dir))
            child.feed(["FLUSH"])
            # the WAL append lands BEFORE the (chaos-delayed) send: the
            # moment a fresh segment is on disk the flush is mid-send;
            # kill -9 now
            assert wait_until(
                lambda: set(_wal_segments(wal_dir)) - before,
                timeout=60.0), "WAL segment never appeared before the ack"
            child.kill()  # its launches never reached a FLUSHED line
            report["kills"] += 1
            # restart with chaos OFF: the re-scan replays the log
            child = _Child(wal_dir, f_imp.address, 0.0, device)
            report["restarts"] += 1
            child.flush()  # drains the replayed segment
            assert wait_until(lambda: not _wal_segments(wal_dir),
                              timeout=30.0), "WAL did not drain"
            if verbose:
                print(f"round {round_no}: killed + replayed")
            report["rounds"].append({
                "round": round_no,
                "seconds": round(time.perf_counter() - t_round, 3)})
        # a clean final round on both pipelines
        lines = lines_for(kills, counters_per_round, value)
        if child is None:
            child = _Child(wal_dir, f_imp.address, 0.0, device)
        child.flush(lines)
        ctl.flush(lines)
    finally:
        for proc in (child, ctl):
            if proc is not None:
                retire(proc)
        shutil.rmtree(tmp, ignore_errors=True)

    try:
        # the diff: zero counter loss, llhist registers bit-identical
        f_counters = counter_sums(faulted)
        c_counters = counter_sums(control)
        assert f_counters == c_counters, (
            f"counter loss: faulted {f_counters} != control {c_counters}")
        f_bins = llhist_bins(faulted)
        c_bins = llhist_bins(control)
        assert set(f_bins) == set(c_bins), (set(f_bins), set(c_bins))
        for name in f_bins:
            assert np.array_equal(f_bins[name], c_bins[name]), (
                f"llhist registers diverge for {name}")
        # zero unexplained imbalance on the receiving tier
        faulted.ledger.close_interval()
        control.ledger.close_interval()
        report["dedupe_drops"] = f_imp.duplicates_dropped_total
    finally:
        f_imp.stop()
        c_imp.stop()
    report["counters"] = c_counters
    report["llhist"] = {
        name: {int(b): int(bins[b]) for b in np.flatnonzero(bins)}
        for name, bins in sorted(c_bins.items())}
    report["launches"] = launches
    report["seconds"] = round(time.perf_counter() - t0, 3)
    return report


def main(argv=None) -> int:
    if os.environ.get(CHILD_ENV_FLAG):
        run_child()
        return 0
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kills", type=int, default=3)
    ap.add_argument("--counters-per-round", type=int, default=40)
    ap.add_argument("--value", type=int, default=3)
    ap.add_argument("--chaos-ms", type=float, default=20_000.0)
    ap.add_argument("-device", default="cuda:0",
                    help="the globals' and children's table device "
                         "(default the card)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    report = run_soak(kills=args.kills,
                      counters_per_round=args.counters_per_round,
                      value=args.value, chaos_ms=args.chaos_ms,
                      device=args.device, verbose=args.verbose)
    print(json.dumps(report, indent=2, default=str))
    print(f"ok: {report['kills']} kill(s), {report['restarts']} "
          f"restart(s), zero loss, llhist bit-exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
