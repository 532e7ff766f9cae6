"""Counter and gauge column ops (torch port of veneur_tpu/ops/scalars.py).

Counters accumulate trunc(value / rate) per sample (parity with reference
samplers/samplers.go:109-111, which truncates each contribution to int64);
gauges are last-write-wins within and across batches (reference
samplers.go:160-162), and an imported gauge overwrites (merge_gauges).

Both update the state dict IN PLACE, where the JAX package donated the
state buffers to its jitted kernels.

Rows outside [0, K) — the PAD_ROW padding — are dropped, as JAX's
`mode="drop"` scatters drop them. Torch has no drop mode (an out-of-range
index is a device-side assert that poisons the CUDA context), so every
scatter here first redirects invalid rows to a trash slot at index K of a
K+1 scratch buffer. No host sync is involved.
"""

from __future__ import annotations

import torch


def masked_rows(rows: torch.Tensor, num_keys: int) -> torch.Tensor:
    """int64 rows with every row outside [0, num_keys) redirected to
    num_keys, the trash slot of a (num_keys + 1) scatter target."""
    rows = rows.long()
    valid = (rows >= 0) & (rows < num_keys)
    return torch.where(valid, rows, num_keys)


def init_counters(num_keys: int, device) -> dict:
    """Kahan-compensated f32 accumulator pair: counters are exact integer
    counts in the reference (int64); compensated summation keeps the f32
    device accumulator exact past 2^24 samples per interval."""
    return {
        "sum": torch.zeros(num_keys, dtype=torch.float32, device=device),
        "comp": torch.zeros(num_keys, dtype=torch.float32, device=device),
    }


def apply_counters(state: dict, rows, values, rates) -> dict:
    """Fold one batch into the Kahan pair in place. The per-key partials
    are sums of integers, so the float atomics' order on the card does
    not change them while each stays below 2^24."""
    num_keys = state["sum"].shape[0]
    contrib = torch.trunc(values / rates)
    idx = masked_rows(rows, num_keys)
    partial = torch.zeros(num_keys + 1, dtype=torch.float32,
                          device=contrib.device)
    partial.index_add_(0, idx, contrib)
    y = partial[:num_keys] - state["comp"]
    t = state["sum"] + y
    state["comp"].copy_((t - state["sum"]) - y)
    state["sum"].copy_(t)
    return state


def counter_values(state: dict) -> torch.Tensor:
    return state["sum"] - state["comp"]


def init_gauges(num_keys: int, device) -> dict:
    return {
        "value": torch.zeros(num_keys, dtype=torch.float32, device=device),
        "set": torch.zeros(num_keys, dtype=torch.bool, device=device),
    }


def apply_gauges(state: dict, rows, values) -> dict:
    """Last-write-wins in place: each row keeps the batch's last
    occurrence, found as a scatter-max of the batch index (deterministic
    in any atomic order)."""
    if rows.shape[0] == 0:
        return state
    num_keys = state["value"].shape[0]
    order = torch.arange(rows.shape[0], dtype=torch.int64,
                         device=values.device)
    last = torch.full((num_keys + 1,), -1, dtype=torch.int64,
                      device=values.device)
    last.scatter_reduce_(0, masked_rows(rows, num_keys), order, "amax",
                         include_self=True)
    last = last[:num_keys]
    touched = last >= 0
    picked = values[last.clamp(min=0)]
    state["value"].copy_(torch.where(touched, picked, state["value"]))
    state["set"] |= touched
    return state


def merge_gauges(state: dict, rows, in_values) -> dict:
    """Import-path merge, in place: overwrite (reference
    samplers.go:200-202). Within one import batch the last value wins,
    the reference's nondeterministic-order caveat (README.md:229); the
    arithmetic is apply_gauges'."""
    return apply_gauges(state, rows, in_values)
