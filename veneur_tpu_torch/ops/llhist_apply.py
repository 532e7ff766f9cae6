"""K3: the llhist scatter-add, a CUDA kernel and its plain PyTorch
version.

Replaces the Pallas TPU kernel `veneur_tpu/ops/pallas_llhist.py:55`
`_apply_pallas` (body `_kernel`), dispatched in the JAX package by
`batch_llhist.apply_batch`. Adds int32 weights at (row, bin) into the
(K, BINS_PAD) int32 register table, in place. Samples whose row lies
outside [0, K) (the PAD_ROW padding of a pending buffer) or whose bin
lies outside [0, BINS_PAD) are dropped, as the JAX package's effective
path `regs.at[rows, bins].add(w, mode="drop")` drops them: the Pallas
kernel does not trace under the installed JAX (`pl.load` is gone), and
on a TPU that failure latches the jnp path at first use.

The kernel (csrc/llhist_apply.cu) is one thread per sample with an
integer atomicAdd; see the source note for its bound. Integer adds are
exact in any order, so kernel, plain version and JAX agree bit for bit.
The wrapper takes the plain version for a CPU tensor only: for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from veneur_tpu_torch.ops import _cuda

BINS_PAD = 4608  # the JAX package's padded width (4501 bins, 128-aligned)

# kernel launches by apply_cuda (the chip smoke reads this to show the
# main path went through the kernel)
launches = 0


def _check(regs, rows, bins, wts) -> None:
    if regs.dtype != torch.int32 or regs.dim() != 2 \
            or regs.shape[1] != BINS_PAD:
        raise ValueError(f"llhist_apply: regs must be (K, {BINS_PAD}) "
                         f"int32, got {tuple(regs.shape)} {regs.dtype}")
    if not regs.is_contiguous():
        raise ValueError("llhist_apply: regs must be contiguous")
    for name, col in (("rows", rows), ("bins", bins), ("wts", wts)):
        if col.dtype != torch.int32 or col.dim() != 1:
            raise ValueError(f"llhist_apply: {name} must be 1-D int32, got "
                             f"{tuple(col.shape)} {col.dtype}")
        if col.shape[0] != rows.shape[0]:
            raise ValueError("llhist_apply: rows, bins and wts differ in "
                             "length")
        if col.device != regs.device:
            raise ValueError(f"llhist_apply: {name} on {col.device}, regs "
                             f"on {regs.device}")


def apply_plain(regs: torch.Tensor, rows: torch.Tensor, bins: torch.Tensor,
                wts: torch.Tensor) -> torch.Tensor:
    """K3's plain version: mask both indices, then one accumulating
    index_put_."""
    _check(regs, rows, bins, wts)
    keep = ((rows >= 0) & (rows < regs.shape[0])
            & (bins >= 0) & (bins < BINS_PAD))
    regs.index_put_((rows[keep].long(), bins[keep].long()), wts[keep],
                    accumulate=True)
    return regs


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]


def apply_cuda(regs: torch.Tensor, rows: torch.Tensor, bins: torch.Tensor,
               wts: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the current stream (no synchronisation)."""
    global launches
    if regs.device.type != "cuda":
        raise ValueError(f"llhist_apply: regs must be on a CUDA device, "
                         f"got {regs.device}")
    _check(regs, rows, bins, wts)
    rows, bins, wts = (c.contiguous() for c in (rows, bins, wts))
    n = rows.shape[0]
    if n == 0 or regs.shape[0] == 0:
        return regs
    fn = _cuda.kernel("llhist_apply", "llhist_apply", _ARGTYPES)
    with torch.cuda.device(regs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(regs.data_ptr(), rows.data_ptr(), bins.data_ptr(),
                 wts.data_ptr(), n, regs.shape[0], stream)
    _cuda.check_launch("llhist_apply", err)
    launches += 1
    return regs


def apply(regs: torch.Tensor, rows: torch.Tensor, bins: torch.Tensor,
          wts: torch.Tensor) -> torch.Tensor:
    """Scatter-add in place: the plain version for a CPU tensor, kernel
    K3 for a CUDA tensor."""
    if regs.device.type == "cpu":
        return apply_plain(regs, rows, bins, wts)
    if regs.device.type == "cuda":
        return apply_cuda(regs, rows, bins, wts)
    raise ValueError(f"llhist_apply: unsupported device {regs.device}")


def bound_bytes(num_samples: int, num_registers: int) -> int:
    """Bytes K3 must move: each sample's row, bin and weight read once,
    and each distinct in-range register it adds to read and written
    once."""
    return num_samples * 12 + num_registers * 8
