"""Build and load the port's CUDA kernels.

Each source in `veneur_tpu_torch/csrc/*.cu` has a plain C interface and
compiles with `nvcc` into its own shared library on first use, loaded with
ctypes. No PyTorch header is involved, so a build takes seconds. All
missing libraries build together, one nvcc process per source, started at
once. A library is named by a hash of its source, the shared headers and
the flags, under `build/torch_kernels/` beside the package.

A missing nvcc or a failed build raises with nvcc's output: there is no
fall back to another implementation.

The first use of a kernel in a process (the build of every missing
library, then the library's load) is the port's only compile: its
seconds are kept per kernel in `load_seconds` and handed to every
subscriber (`subscribe_loads`, the device observatory's note_compile).

`-fmad=false` keeps nvcc from contracting a*b+c into one fused
multiply-add, so a kernel rounds like its plain PyTorch version, op for
op. No `--use_fast_math`: the outputs carry ±inf and NaN by contract.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import Callable, Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_BUILD_TIMEOUT_S = 600

_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}
# (library, symbol) -> entry point with argtypes set; read without the lock
_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# kernel name -> nvcc/ptxas output of its build in this process (registers,
# shared memory and spills per kernel, from -Xptxas -v)
build_logs: Dict[str, str] = {}
# kernel name -> seconds of its first use in this process (build + load)
load_seconds: Dict[str, float] = {}
# weak references to the bound methods told of each first use
_load_subscribers: List[weakref.WeakMethod] = []


def subscribe_loads(method: Callable[[str, float], None]) -> None:
    """Call `method(kernel, seconds)` (a bound method, held weakly) for
    every kernel loaded so far and at every later first use."""
    with _lock:
        _load_subscribers.append(weakref.WeakMethod(method))
        loaded = list(load_seconds.items())
    for name, seconds in loaded:
        method(name, seconds)


def _notify_load(name: str, seconds: float) -> None:
    """Tell the live subscribers (caller holds ``_lock``)."""
    load_seconds[name] = seconds
    alive = []
    for ref in _load_subscribers:
        method = ref()
        if method is not None:
            alive.append(ref)
            method(name, seconds)
    _load_subscribers[:] = alive


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels build from source on first use")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every kernel library that is not built yet, one nvcc per
    source, all running at once. Returns name -> library path."""
    with _lock:
        todo, paths = [], {}
        for src in sources():
            paths[src.stem] = out = _library_path(src)
            if not out.exists():
                todo.append((src, out))
        if not todo:
            return paths
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        try:
            for src, out in todo:
                tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
                procs.append((src, out, tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            errors = []
            for src, out, tmp, proc in procs:
                stdout, stderr = proc.communicate(timeout=_BUILD_TIMEOUT_S)
                if proc.returncode != 0:
                    errors.append(f"{src.name} (exit {proc.returncode}):\n"
                                  f"{stdout}{stderr}")
                    continue
                os.replace(tmp, out)
                build_logs[src.stem] = stdout + stderr
        finally:
            for _src, _out, tmp, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if tmp.exists():
                    tmp.unlink()
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        return paths


def kernel(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of kernel library `name`, built on first
    use. Every entry point returns the launch's cudaGetLastError() as
    an int (0 = launched). The function object is resolved once, with its
    argtypes and restype set; later calls take no lock and assign
    nothing."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        fn = _fns.get((name, symbol))
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                t0 = time.perf_counter()
                paths = build_all()
                if name not in paths:
                    raise RuntimeError(f"no kernel source csrc/{name}.cu")
                lib = _libs[name] = ctypes.CDLL(str(paths[name]))
                _notify_load(name, time.perf_counter() - t0)
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[(name, symbol)] = fn
    return fn


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
