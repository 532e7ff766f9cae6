"""Reshard SIGKILL soak: kill a sharded server mid-cutover, after its
range segments are durable and before the merge-back ran, restart it,
replay the WAL, and diff its flush against a never-resharded control
(torch port of scripts/reshard_soak.py).

What it exercises (parallel/reshard.py):

- the cutover WAL-appends every migrating digest-range cell's captured
  state (metricpb wire, one spool segment per cell) BEFORE any state
  moves onto the new plane;
- a `kill -9` landing between the append and the merge-back loses
  nothing: the restarted process replays the range segments at start()
  into whatever topology its config builds, which this soak makes
  DIFFERENT from the killed cutover's target on purpose (the child
  restarts at the old shard count);
- segments are popped only after their merge lands, so the replay is
  exactly-once: a second scan finds an empty spool.

The kill is made deterministic: the child runs with
`chaos_reshard_cutover_delay_s` high enough that the cutover sleeps
between the appends and the merges, and says so when it enters the
sleep; the parent waits for that word (every append happened, the
merge has not), checks the range segments on disk, and then sends
SIGKILL. The restarted child runs with chaos off. (Killing at the first
segment seen on disk, as scripts/reshard_soak.py does, can land between
two appends and lose the cells not yet written.)

The invariant is exactness: after N kill/restart rounds the faulted
server's flush equals an unfaulted control fed the same stream, every
family, counters, gauges, llhist and HLL rows bit for bit, t-digest
percentile rows within the migration's one recompress (rtol 1e-6).
`ledger_strict` is on in both children, so a conservation break raises
out of flush() and "FLUSHED" never prints.

Run (the children's tables on the card unless `-device cpu`):

    python -m veneur_tpu_torch.cmd.reshard_soak --kills 2 [-device cpu]
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

CHILD_ENV_FLAG = "RESHARD_SOAK_CHILD"
SHARDS_OLD = 2
SHARDS_NEW = 3


def wait_until(pred, timeout=120.0, step=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


# ---------------------------------------------------------------------------
# child: one sharded server, reshard WAL on, feed protocol over stdin
# ---------------------------------------------------------------------------


def run_child() -> None:
    """Child-process entry: a sharded Server (strict ledger) on
    $SOAK_DEVICE. Feed protocol: metric lines apply on `APPLY`;
    `RESHARD <n>` starts a live reshard (chaos holds the cutover open
    mid-WAL so the parent can SIGKILL inside the crash window); `FLUSH`
    flushes and prints the flushed rows as JSON; EOF exits."""
    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    raw = {
        "interval": "3600s",  # flushes are driven by the feed protocol
        "hostname": "reshard-soak",
        "statsd_listen_addresses": [],
        "reshard_spool_dir": os.environ["SOAK_RESHARD_WAL"],
        # zero unexplained imbalance through the kill/replay cycle:
        # strict raises out of flush(), so "FLUSHED" never prints
        "ledger_strict": True,
        "tpu": {"shards": SHARDS_OLD, "counter_capacity": 128,
                "gauge_capacity": 128, "histo_capacity": 128,
                "set_capacity": 64, "llhist_capacity": 64,
                "batch_cap": 512},
    }
    delay_s = float(os.environ.get("SOAK_CUTOVER_DELAY_S", "0"))
    if delay_s:
        raw["chaos_enabled"] = True
        raw["chaos_reshard_cutover_delay_s"] = delay_s
    obs = ChannelMetricSink()
    server = Server(config_from_dict(raw), device=os.environ["SOAK_DEVICE"],
                    extra_metric_sinks=[obs])
    # the span extraction's 1-in-100 ssf.names_unique roll would add a
    # row of the server's own flush spans to one flush and not the other
    server.metric_extraction.uniqueness_rate = 0.0
    if delay_s:
        hold = server.chaos.reshard_cutover_delay

        def held():
            # every range segment is appended: the crash window is open
            print("CUTOVER_HELD", flush=True)
            hold()
        server.chaos.reshard_cutover_delay = held
    server.start()  # replays any range segments a killed round left
    print("READY", flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line == "APPLY":
            server.store.apply_all_pending()
            print("APPLIED", flush=True)
        elif line.startswith("RESHARD "):
            server.reshard.begin(shards=int(line.split()[1]),
                                 deadline_s=600.0)
            print("RESHARD_STARTED", flush=True)
        elif line == "FLUSH":
            server.store.apply_all_pending()
            server.flush()
            rows = {f"{m.name}|{','.join(sorted(m.tags))}": float(m.value)
                    for m in obs.drain()}
            print("FLUSHED " + json.dumps(rows, sort_keys=True),
                  flush=True)
        else:
            server.handle_metric_packet(line.encode())
    server.config.flush_on_shutdown = False
    server.shutdown()
    print("DONE", flush=True)


# ---------------------------------------------------------------------------
# parent: the kill loop
# ---------------------------------------------------------------------------


class _Child:
    """A child process and a reader thread over its stdout, so that every
    wait has a timeout even when the child hangs."""

    def __init__(self, wal_dir: str, cutover_delay_s: float, device: str):
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env.update({
            CHILD_ENV_FLAG: "1",
            "PYTHONPATH": os.pathsep.join(
                p for p in (root, env.get("PYTHONPATH", "")) if p),
            "SOAK_RESHARD_WAL": wal_dir,
            "SOAK_CUTOVER_DELAY_S": str(cutover_delay_s),
            "SOAK_DEVICE": device,
        })
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.cmd.reshard_soak"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
            cwd=root, text=True, bufsize=1)
        self._lines: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()
        self.expect("READY", timeout=300.0)

    def _read(self) -> None:
        for line in self.proc.stdout:
            self._lines.put(line.strip())
        self._lines.put(None)  # EOF

    def feed(self, lines) -> None:
        for line in lines:
            self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def expect(self, prefix: str, timeout: float = 300.0) -> str:
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

    def flush(self) -> dict:
        self.feed(["FLUSH"])
        return json.loads(self.expect("FLUSHED ")[len("FLUSHED "):])

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


def _compare(faulted: dict, control: dict) -> int:
    """Exact row-for-row equality except t-digest percentile rows
    (re-compressed once by the migration; rtol pins them)."""
    assert set(faulted) == set(control), (
        sorted(set(control) - set(faulted))[:5],
        sorted(set(faulted) - set(control))[:5])
    checked = 0
    for key, want in control.items():
        got = faulted[key]
        if key.split("|", 1)[0].endswith("percentile"):
            assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), (
                key, got, want)
        else:
            assert got == want, (key, got, want)
        checked += 1
    return checked


def lines_for(round_no: int):
    out = []
    for i in range(16):
        out.append(f"soak.rs.c.{i}:{i + 1 + round_no}|c|#env:soak")
        out.append(f"soak.rs.t.{i}:{10.0 + i + round_no:.1f}|ms")
        out.append(f"soak.rs.ll.{i}:{(round_no * 17 + i) % 91}|l")
        out.append(f"soak.rs.s.{i}:m{(round_no * 7 + i) % 23}|s")
        out.append(f"soak.rs.g.{i}:{i * 1.5 + round_no:.2f}|g")
    return out


def run_soak(kills: int = 2, cutover_delay_s: float = 120.0,
             device: str = "cuda:0", verbose: bool = False) -> dict:
    """`kills` rounds of feed -> reshard -> SIGKILL mid-WAL -> restart
    -> replay -> flush and diff against an unfaulted control, the
    children's tables on `device`. Returns the report (with each
    round's seconds); raises AssertionError when an invariant breaks."""
    tmp = tempfile.mkdtemp(prefix="reshard-soak-")
    wal_dir = os.path.join(tmp, "reshard-wal")
    report = {"kills": 0, "restarts": 0, "rounds": [], "device": device}
    t0 = time.perf_counter()
    child = None
    ctl = _Child(os.path.join(tmp, "ctl-wal"), 0.0, device)
    try:
        for round_no in range(kills):
            t_round = time.perf_counter()
            if child is not None:
                # the previous round's replay child ran chaos-free;
                # each kill round needs the hold-open seam back
                child.kill()
            child = _Child(wal_dir, cutover_delay_s, device)
            lines = lines_for(round_no)
            for proc in (child, ctl):
                proc.feed(lines + ["APPLY"])
                proc.expect("APPLIED")
            before = set(_wal_segments(wal_dir))
            child.feed([f"RESHARD {SHARDS_NEW}"])
            child.expect("RESHARD_STARTED")
            # the WAL appends land, then chaos holds the cutover open:
            # the merge has not run; kill -9 now, inside the crash window
            child.expect("CUTOVER_HELD", timeout=600.0)
            segments = len(set(_wal_segments(wal_dir)) - before)
            assert segments, "no range segment on disk"
            child.kill()
            report["kills"] += 1
            # restart with chaos OFF at the OLD shard count: start()
            # replays the log into a topology that differs from the
            # killed cutover's target on purpose
            child = _Child(wal_dir, 0.0, device)
            report["restarts"] += 1
            assert wait_until(lambda: not _wal_segments(wal_dir),
                              timeout=30.0), "reshard WAL did not drain"
            # post-restart ingest keeps landing, then the diff
            post = lines_for(round_no + 100)
            for proc in (child, ctl):
                proc.feed(post + ["APPLY"])
                proc.expect("APPLIED")
            rows = _compare(child.flush(), ctl.flush())
            if verbose:
                print(f"round {round_no}: killed with {segments} range "
                      f"segments on disk, replayed, {rows} flush rows "
                      f"match")
            report["rounds"].append({
                "round": round_no, "rows": rows, "segments": segments,
                "seconds": round(time.perf_counter() - t_round, 3)})
    finally:
        for proc in (child, ctl):
            if proc is not None:
                proc.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    report["seconds"] = round(time.perf_counter() - t0, 3)
    return report


def main(argv=None) -> int:
    if os.environ.get(CHILD_ENV_FLAG):
        run_child()
        return 0
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kills", type=int, default=2)
    ap.add_argument("--cutover-delay-s", type=float, default=120.0)
    ap.add_argument("-device", default="cuda:0",
                    help="the children's table device (default the card)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    report = run_soak(kills=args.kills,
                      cutover_delay_s=args.cutover_delay_s,
                      device=args.device, verbose=args.verbose)
    print(json.dumps(report, indent=2))
    print(f"ok: {report['kills']} kill(s), {report['restarts']} "
          f"restart(s), zero loss, flush bit-identical to control")
    return 0


if __name__ == "__main__":
    sys.exit(main())
