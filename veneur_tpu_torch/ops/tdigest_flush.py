"""K1: the t-digest flush interpolation, a CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel `veneur_tpu/ops/pallas_tdigest.py`
`_flush_pallas` (body `_flush_block`), which the JAX package enters from
`batch_tdigest.flush_quantiles_packed_pallas`. From per-row mean-sorted
centroids `sm`, `sw` (K, W) and the eight per-key scalars (K, 8) it
writes the packed (K, P+10) flush rows: the P quantiles, then
FLUSH_SCALARS. The sort before it stays a library sort.

The kernel (csrc/tdigest_flush.cu) is one warp per row; see the source
note for its design and byte bound. The wrapper takes the plain version
for a CPU tensor only: for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from veneur_tpu_torch.ops import _cuda

# column order of the scalar tail of the packed flush
FLUSH_SCALARS = ("count", "sum", "min", "max", "hmean",
                 "lmin", "lmax", "lsum", "lweight", "lrecip")
# column order of the kernel's (K, 8) scalar input
SCALARS_IN = ("dmin", "dmax", "drecip", "lmin", "lmax", "lsum",
              "lweight", "lrecip")
MAX_PERCENTILES = 16
# main grid only (C) or staging folded (2C); each lane loads W/32 slots
WIDTHS = (128, 256)

# kernel launches by flush_packed_cuda (the chip smoke reads this to show
# the main path went through the kernel)
launches = 0


def scalars_of(state) -> torch.Tensor:
    """Stack the per-key scalar columns into the kernel's (K, 8) input."""
    return torch.stack([state[k] for k in SCALARS_IN], dim=-1)


def _quantiles_from_sorted(sm, sw, cum, dmin, dmax, ps):
    """Quantile interpolation over per-row mean-sorted centroids (parity
    with merging_digest.go:302-332: uniform within centroid, bounds at
    neighbour midpoints, min/max at the ends)."""
    num_keys, width = sm.shape
    tot = cum[:, -1]
    n = (sw > 0).sum(dim=-1)
    next_m = torch.cat([sm[:, 1:], sm.new_zeros((num_keys, 1))], dim=-1)
    idx = torch.arange(width, device=sm.device)[None, :]
    ub = torch.where(idx == (n - 1)[:, None], dmax[:, None],
                     (next_m + sm) * 0.5)
    lb = torch.cat([dmin[:, None], ub[:, :-1]], dim=-1)
    q_t = ps[None, :] * tot[:, None]  # (K, P)
    # first centroid index with cum >= q_t
    i_star = (cum[:, None, :] < q_t[:, :, None]).sum(dim=-1)
    i_star = torch.minimum(i_star, (n - 1).clamp(min=0)[:, None])
    w_i = torch.gather(sw, 1, i_star)
    cum_i = torch.gather(cum, 1, i_star)
    lb_i = torch.gather(lb, 1, i_star)
    ub_i = torch.gather(ub, 1, i_star)
    proportion = (q_t - (cum_i - w_i)) / w_i.clamp(min=1e-30)
    quant = lb_i + proportion * (ub_i - lb_i)
    return torch.where((n > 0)[:, None], quant, float("nan"))


def _flush_outputs(quant, sm, sw, cum, scal):
    dcount = cum[:, -1]
    dmin, dmax, drecip, lmin, lmax, lsum, lweight, lrecip = scal.unbind(-1)
    return {
        "quantiles": quant,
        "count": dcount,
        "sum": (sm * sw).sum(dim=-1),
        "min": dmin,
        "max": dmax,
        "hmean": torch.where(drecip != 0, dcount / drecip, float("nan")),
        "lmin": lmin,
        "lmax": lmax,
        "lsum": lsum,
        "lweight": lweight,
        "lrecip": lrecip,
    }


def _pack_flush(out):
    cols = [out["quantiles"]] + [out[k][:, None] for k in FLUSH_SCALARS]
    return torch.cat(cols, dim=-1)


def _percentiles_on(ps, device) -> torch.Tensor:
    return torch.as_tensor(ps, dtype=torch.float32, device=device)


def flush_packed_plain(sm, sw, scal, ps) -> torch.Tensor:
    """K1's plain version: _quantiles_from_sorted + _flush_outputs +
    _pack_flush of the JAX package, in torch."""
    ps = _percentiles_on(ps, sm.device)
    cum = torch.cumsum(sw, dim=-1)
    quant = _quantiles_from_sorted(sm, sw, cum, scal[:, 0], scal[:, 1], ps)
    return _pack_flush(_flush_outputs(quant, sm, sw, cum, scal))


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def flush_packed_cuda(sm, sw, scal, ps) -> torch.Tensor:
    """Launch K1 on the current stream (no synchronisation)."""
    global launches
    ps = _percentiles_on(ps, sm.device)
    num_keys, width = sm.shape if sm.dim() == 2 else (-1, -1)
    num_ps = ps.shape[0] if ps.dim() == 1 else -1
    for name, t, shape in (("sm", sm, (num_keys, width)),
                           ("sw", sw, (num_keys, width)),
                           ("scal", scal, (num_keys, len(SCALARS_IN))),
                           ("ps", ps, (num_ps,))):
        if t.device != sm.device or t.device.type != "cuda":
            raise ValueError(f"tdigest_flush: {name} must be on the CUDA "
                             f"device of sm ({sm.device}), got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"tdigest_flush: {name} must be float32, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"tdigest_flush: {name} shape {tuple(t.shape)}"
                             f", expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"tdigest_flush: {name} must be contiguous")
    if width not in WIDTHS:
        raise ValueError(f"tdigest_flush: width {width} not in {WIDTHS}")
    if not 1 <= num_ps <= MAX_PERCENTILES:
        raise ValueError(f"tdigest_flush: {num_ps} percentiles, the kernel "
                         f"takes 1..{MAX_PERCENTILES}")
    if sm.data_ptr() % 16 or sw.data_ptr() % 16:
        raise ValueError("tdigest_flush: sm and sw must be 16-byte aligned")
    out = torch.empty((num_keys, num_ps + 10), dtype=torch.float32,
                      device=sm.device)
    if num_keys == 0:
        return out
    fn = _cuda.kernel("tdigest_flush", "tdigest_flush", _ARGTYPES)
    with torch.cuda.device(sm.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(sm.data_ptr(), sw.data_ptr(), scal.data_ptr(),
                 ps.data_ptr(), out.data_ptr(), num_keys, width, num_ps,
                 stream)
    _cuda.check_launch("tdigest_flush", err)
    launches += 1
    return out


def flush_packed(sm, sw, scal, ps: Sequence[float]) -> torch.Tensor:
    """Packed (K, P+10) flush rows from mean-sorted centroids: the plain
    version for CPU tensors, kernel K1 for CUDA tensors."""
    if sm.device.type == "cpu":
        return flush_packed_plain(sm, sw, scal, ps)
    if sm.device.type == "cuda":
        return flush_packed_cuda(sm, sw, scal, ps)
    raise ValueError(f"tdigest_flush: unsupported device {sm.device}")


def bound_bytes(num_keys: int, width: int, num_ps: int) -> int:
    """Bytes K1 must move: sm and sw read once, the scalars read once,
    the packed rows written once (the percentile vector is negligible)."""
    return (num_keys * width * 8 + num_keys * len(SCALARS_IN) * 4
            + num_keys * (num_ps + 10) * 4)
