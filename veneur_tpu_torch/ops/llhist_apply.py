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

The kernel (csrc/llhist_apply.cu) gives each thread 4 samples read with
16-byte loads and one integer atomicAdd per sample; see the source note
for its bound. Integer adds are exact in any order, so kernel, plain
version and JAX agree bit for bit. The wrapper takes the plain version for a CPU tensor only: for a
CUDA tensor it launches the kernel or raises.

The launch path is kept thin, since at an ingest chunk's size the host's
cost per call, not the device's, sets the time: the checks are plain
comparisons (a message is built only on failure), the C entry point is
resolved once, the stream handle is read without building a Stream, and
no device context is entered when the table lies on the current device.
"""

from __future__ import annotations

import ctypes

import torch

from veneur_tpu_torch.ops import _cuda

BINS_PAD = 4608  # the JAX package's padded width (4501 bins, 128-aligned)

# kernel launches by apply_cuda (the chip smoke reads this to show the
# main path went through the kernel)
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]
_INT32 = torch.int32
# the kernel's C entry point, and whether the process sees more than one
# card (with one, a table always lies on the current device); both set
# by the first launch
_fn = None
_many_cards = False


def _check(regs, rows, bins, wts, kernel: bool = False):
    """Raise on what the plain version, or with `kernel` the kernel,
    does not take: the kernel also needs contiguous tensors and a table
    on a CUDA device. Returns (K, n, device index). Each property is read
    once: at an ingest chunk's size the host's cost per call sets K3's
    time."""
    shape, length, index = regs.shape, rows.shape, regs.get_device()
    if regs.dtype is not _INT32 or len(shape) != 2 or shape[1] != BINS_PAD:
        raise ValueError(f"llhist_apply: regs must be (K, {BINS_PAD}) "
                         f"int32, got {tuple(shape)} {regs.dtype}")
    if not regs.is_contiguous():
        raise ValueError("llhist_apply: regs must be contiguous")
    if rows.dtype is not _INT32 or bins.dtype is not _INT32 \
            or wts.dtype is not _INT32 or len(length) != 1:
        raise ValueError(f"llhist_apply: rows, bins and wts must be 1-D "
                         f"int32, got {tuple(length)} {rows.dtype}, "
                         f"{bins.dtype}, {wts.dtype}")
    if bins.shape != length or wts.shape != length:
        raise ValueError("llhist_apply: rows, bins and wts differ in shape")
    if rows.get_device() != index or bins.get_device() != index \
            or wts.get_device() != index:
        raise ValueError(f"llhist_apply: rows, bins and wts must be on "
                         f"{regs.device}")
    if kernel and not (rows.is_contiguous() and bins.is_contiguous()
                       and wts.is_contiguous()):
        raise ValueError("llhist_apply: rows, bins and wts must be "
                         "contiguous")
    if kernel and not regs.is_cuda:
        raise ValueError(f"llhist_apply: regs must be on a CUDA device, got "
                         f"{regs.device}")
    return shape[0], length[0], index


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


def apply_cuda(regs: torch.Tensor, rows: torch.Tensor, bins: torch.Tensor,
               wts: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the current stream (no synchronisation). The columns
    must be contiguous 1-D int32 of one length, on regs' CUDA device."""
    global launches, _fn, _many_cards
    num_keys, n, index = _check(regs, rows, bins, wts, kernel=True)
    if n == 0 or num_keys == 0:
        return regs
    if _fn is None:
        _fn = _cuda.kernel("llhist_apply", "llhist_apply", _ARGTYPES)
        _many_cards = torch.cuda.device_count() > 1
    # the raw handle of the device's current stream, what
    # current_stream(index).cuda_stream gives without building a Stream
    # (a few microseconds a call, PERF.md)
    args = (regs.data_ptr(), rows.data_ptr(), bins.data_ptr(),
            wts.data_ptr(), n, num_keys,
            torch._C._cuda_getCurrentRawStream(index))
    if not _many_cards or index == torch.cuda.current_device():
        err = _fn(*args)
    else:
        with torch.cuda.device(index):
            err = _fn(*args)
    if err:
        _cuda.check_launch("llhist_apply", err)
    launches += 1
    return regs


def apply(regs: torch.Tensor, rows: torch.Tensor, bins: torch.Tensor,
          wts: torch.Tensor) -> torch.Tensor:
    """Scatter-add in place: the plain version for a CPU tensor, kernel
    K3 for a CUDA tensor."""
    if regs.is_cuda:
        return apply_cuda(regs, rows, bins, wts)
    if regs.device.type == "cpu":
        return apply_plain(regs, rows, bins, wts)
    raise ValueError(f"llhist_apply: unsupported device {regs.device}")


def bound_bytes(num_samples: int, num_registers: int) -> int:
    """Bytes K3 must move: each sample's row, bin and weight read once,
    and each distinct in-range register it adds to read and written
    once."""
    return num_samples * 12 + num_registers * 8
