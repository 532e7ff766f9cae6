"""K2: the HyperLogLog LogLog-Beta estimate, a CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel `veneur_tpu/ops/pallas_hll.py`
`_estimate_pallas` (body `_estimate_block`), dispatched in the JAX package
by `batch_hll.estimate`. Registers (D, 16384) int8 in, estimates (D,)
float32 out (parity with the reference's vendored estimator,
hyperloglog.go:207-231 + utils.go:12-22).

The kernel (csrc/hll_estimate.cu) is one block per row; see the source
note for its design and byte bound. The wrapper takes the plain version
for a CPU tensor only: for a CUDA tensor it launches the kernel or raises.

Both versions sum the exact terms 2^-reg in float64 and round the sum to
float32 once, then evaluate the tail in float32 in the order of the JAX
package's `_estimate_jnp`. Against the JAX package (which sums in
float32) the final floor can therefore move by one where its float32 sum
rounded across an integer boundary of the estimate.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from veneur_tpu_torch.core import profiling
from veneur_tpu_torch.ops import _cuda, count_launch, hll_ref

M = hll_ref.M  # 16384 registers per key

# the JAX package's constants as float32 meets them (Python doubles
# rounded once to float32)
_ALPHA_M = float(np.float32(hll_ref._ALPHA * M))
_BETA_EZ = float(np.float32(hll_ref._BETA14_EZ))
_BETA = tuple(float(np.float32(c)) for c in hll_ref._BETA14)

# kernel launches by estimate_cuda (the chip smoke reads this to show the
# main path went through the kernel)
launches = 0


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x**y as lax.integer_pow evaluates it (binary exponentiation)."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def estimate_plain(regs: torch.Tensor) -> torch.Tensor:
    """K2's plain version: batch_hll._estimate_jnp in torch, with the
    2^-reg terms summed exactly in float64 (see the module note)."""
    ez = (regs == 0).sum(dim=-1).to(torch.float32)
    pow2_neg = torch.tensor([2.0 ** -r for r in range(-128, 128)],
                            dtype=torch.float64, device=regs.device)
    s = pow2_neg[regs.long() + 128].sum(dim=-1).to(torch.float32)
    zl = torch.log(ez + 1.0)
    beta = _BETA_EZ * ez
    for i, c in enumerate(_BETA):
        beta = beta + c * _integer_pow(zl, i + 1)
    est = torch.floor(_ALPHA_M * (M - ez) / (beta + s) + 1.0)
    # a key with no insertions estimates 0
    return torch.where(ez >= M, 0.0, est)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]


def estimate_cuda(regs: torch.Tensor) -> torch.Tensor:
    """Launch K2 on the current stream (no synchronisation)."""
    global launches
    if regs.device.type != "cuda":
        raise ValueError(f"hll_estimate: regs must be on a CUDA device, "
                         f"got {regs.device}")
    if regs.dtype != torch.int8:
        raise TypeError(f"hll_estimate: regs must be int8, got {regs.dtype}")
    if regs.dim() != 2 or regs.shape[1] != M:
        raise ValueError(f"hll_estimate: regs shape {tuple(regs.shape)}, "
                         f"expected (D, {M})")
    if not regs.is_contiguous():
        raise ValueError("hll_estimate: regs must be contiguous")
    if regs.data_ptr() % 16:
        raise ValueError("hll_estimate: regs must be 16-byte aligned")
    num_rows = regs.shape[0]
    out = torch.empty(num_rows, dtype=torch.float32, device=regs.device)
    if num_rows == 0:
        return out
    fn = _cuda.kernel("hll_estimate", "hll_estimate", _ARGTYPES)
    with torch.cuda.device(regs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(regs.data_ptr(), out.data_ptr(), num_rows, stream)
    _cuda.check_launch("hll_estimate", err)
    launches += 1
    count_launch()
    return out


def estimate(regs: torch.Tensor) -> torch.Tensor:
    """Per-key estimates: the plain version for a CPU tensor, kernel K2
    for a CUDA tensor. The call is the span `kernel.k2`, with its shape
    (D,), while the span recorder is armed."""
    armed = profiling.armed
    if armed:
        t0 = time.perf_counter()
    if regs.device.type == "cpu":
        out = estimate_plain(regs)
    elif regs.device.type == "cuda":
        out = estimate_cuda(regs)
    else:
        raise ValueError(f"hll_estimate: unsupported device {regs.device}")
    if armed:
        profiling.record("kernel.k2", t0, time.perf_counter(),
                         {"shape": (int(regs.shape[0]),)})
    return out


def bound_bytes(num_rows: int) -> int:
    """Bytes K2 must move: every register read once, every estimate
    written once."""
    return num_rows * M + num_rows * 4
