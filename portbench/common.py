"""Shared pieces of the harness: the run's directories, the guards a run
must pass, the interval gate, the Datadog receiver's client, spans, and
the result line."""

from __future__ import annotations

import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent

# top-level module names that may not be loaded in a benchmark process:
# the JAX package (its name is a prefix of the port's, so names are
# compared whole) and JAX itself
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "veneur_tpu")


class BenchError(RuntimeError):
    """A run that cannot produce a result (no card, a forbidden import)."""


def set_cache_dirs() -> None:
    """Keep every build and kernel cache inside the checkout at fixed
    paths, so that only a checkout's first run builds. The port's own
    build directories (`build/torch_kernels`, `build/native`) are fixed
    there already; these cover what PyTorch itself may build."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_loaded() -> List[str]:
    """Forbidden top-level modules present in sys.modules."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def require_cards(chips: int) -> str:
    """The card's name, or BenchError when fewer than `chips` cards."""
    import torch
    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} card(s), "
                         f"{torch.cuda.device_count()} present")
    return torch.cuda.get_device_name(0)


class IntervalGate:
    """Makes each ingest batch atomic with respect to each flush's swap,
    so the harness knows which batches every interval held.

    Batches enter shared (`run_batch`), any number at once; a swap
    (`run_swap`) enters alone, and a waiting swap goes before new
    batches. A swap advances `epoch`.
    The log holds (epoch, batch id) for every batch applied, in the order
    the batches finished."""

    def __init__(self):
        self._cv = threading.Condition()
        self._shared = 0
        self._writer = False
        self._writers_waiting = 0
        self.epoch = 0
        self.log: List[tuple] = []

    def _enter_shared(self) -> None:
        with self._cv:
            while self._writer or self._writers_waiting:
                self._cv.wait()
            self._shared += 1

    def _leave_shared(self, batch_id: int) -> None:
        with self._cv:
            self.log.append((self.epoch, batch_id))
            self._shared -= 1
            if not self._shared:
                self._cv.notify_all()

    def _enter_exclusive(self) -> None:
        with self._cv:
            self._writers_waiting += 1
            while self._writer or self._shared:
                self._cv.wait()
            self._writers_waiting -= 1
            self._writer = True

    def _leave_exclusive(self) -> None:
        with self._cv:
            self._writer = False
            self._cv.notify_all()

    def run_batch(self, batch_id: int, fn, *args):
        self._enter_shared()
        try:
            return fn(*args)
        finally:
            self._leave_shared(batch_id)

    def run_swap(self, fn, *args, **kwargs):
        """The swap: the next epoch begins with it."""
        self._enter_exclusive()
        try:
            out = fn(*args, **kwargs)
            self.epoch += 1
            return out
        finally:
            self._leave_exclusive()


class Receiver:
    """The Datadog intake stand-in (portbench/receiver.py) in a child
    process; `cut()` after each flush groups the bodies by flush."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.receiver"], cwd=str(ROOT),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        line = self.proc.stdout.readline()
        if not line:
            raise BenchError("the Datadog receiver did not start")
        self.port = int(line)
        self.url = f"http://127.0.0.1:{self.port}"

    def cut(self) -> None:
        self.proc.stdin.write(b"cut\n")
        self.proc.stdin.flush()

    def finish(self, timeout: float = 120.0) -> List[List[bytes]]:
        """Every group of raw bodies, in flush order; stops the child."""
        self.proc.stdin.write(b"end\n")
        self.proc.stdin.flush()
        out = self.proc.stdout
        groups: List[List[bytes]] = []
        while True:
            line = out.readline()
            if not line:
                raise BenchError("the Datadog receiver ended early")
            if line.startswith(b"group "):
                groups.append([])
            elif line.startswith(b"body "):
                groups[-1].append(out.read(int(line[5:])))
            elif line.strip() == b"done":
                break
        self.proc.wait(timeout=timeout)
        return groups

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


class Spans:
    """The harness's own spans: (name, start, end) on the host clock, and
    a torch.profiler range around each while a trace is on."""

    def __init__(self, traced: bool):
        self.traced = traced
        self._lock = threading.Lock()
        self.items: List[tuple] = []

    def run(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        if self.traced:
            import torch
            with torch.profiler.record_function(f"bench.{name}"):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        t1 = time.perf_counter()
        with self._lock:
            self.items.append((name, t0, t1))
        return out

    def durations(self, name: str, t_from: float = -math.inf,
                  t_to: float = math.inf) -> List[float]:
        with self._lock:
            return [e - s for n, s, e in self.items
                    if n == name and s >= t_from and e <= t_to]


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> dict:
    """The contract's last line; the compared numbers come last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
