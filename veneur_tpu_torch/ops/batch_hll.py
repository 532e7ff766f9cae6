"""Batched HyperLogLog over a (key x register) column store (torch port of
veneur_tpu/ops/batch_hll.py).

The whole table is one dense (K, 16384) int8 tensor; the host hashes
members (fnv1a-64 + finalizer, ops/hll_ref.hash_member) into (row,
register, rho) triples and the device applies them as one scatter-max,
in place (the JAX package donated the table). Merges are elementwise
maxima. The estimate is kernel K2 (ops/hll_estimate.py).
"""

from __future__ import annotations

import torch

from veneur_tpu_torch.ops import hll_estimate, hll_ref

M = hll_ref.M  # 16384 registers per key


def init_state(num_keys: int, device) -> torch.Tensor:
    return torch.zeros((num_keys, M), dtype=torch.int8, device=device)


def apply_batch(regs: torch.Tensor, rows, reg_idx, rho) -> torch.Tensor:
    """Scatter-max a batch of hashed members into `regs` in place. Rows
    outside [0, K) (PAD_ROW padding) are dropped: they are redirected to
    register 0 of row 0 with rho 0, which cannot raise a register."""
    num_keys = regs.shape[0]
    if num_keys == 0 or rows.shape[0] == 0:
        return regs
    rows = rows.long()
    valid = (rows >= 0) & (rows < num_keys)
    flat = torch.where(valid, rows * M + reg_idx.long(), 0)
    src = torch.where(valid, rho, 0).to(torch.int8)
    regs.view(-1).scatter_reduce_(0, flat, src, "amax", include_self=True)
    return regs


def merge(regs_a: torch.Tensor, regs_b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(regs_a, regs_b)


def merge_rows(regs: torch.Tensor, rows, in_regs) -> torch.Tensor:
    """Merge whole incoming register rows (the import path) in place: a
    per-key register max, as one scatter-max along the key axis (the
    set ingest's int8 scatter-max). Rows outside [0, K) are dropped:
    they are redirected to row 0 with all-zero registers, which cannot
    raise a register."""
    num_keys = regs.shape[0]
    if num_keys == 0 or rows.shape[0] == 0:
        return regs
    rows = rows.long()
    valid = (rows >= 0) & (rows < num_keys)
    idx = torch.where(valid, rows, 0)[:, None].expand(-1, regs.shape[1])
    src = torch.where(valid[:, None], in_regs.to(torch.int8), 0)
    regs.scatter_reduce_(0, idx, src, "amax", include_self=True)
    return regs


def estimate(regs: torch.Tensor) -> torch.Tensor:
    """Per-key LogLog-Beta estimate (kernel K2 on the card)."""
    return hll_estimate.estimate(regs)

