"""Interval merges over the shard axis for the sharded serving plane
(torch port of veneur_tpu/parallel/collectives.py).

Every shard aggregates its own slice of the key space, and the
per-interval merge is one reduction over the shard axis: a sum for the
counter Kahan pairs and the llhist registers, a masked sum plus `any`
for gauges, a register max for HLL, concat + recompress for t-digest
centroids, and min, max or sum for the digest scalars. These are the
JAX package's reductions op for op; with digest-home routing each row
has one home shard, so a sum adds n-1 zeros and the merged counters,
gauges, llhist and HLL registers equal a single table's.

The JAX package lays the stacked (n, K, ...) state out over a device
mesh and lets XLA partition the apply. Here the shards are split over
the plane's placement groups (parallel/sharded_server.py): group j
holds the shards j, j+G, ... as one stacked (n_j, K, ...) state on its
device. With one group the state is that one stacked tensor (or dict
of them); with several it is a list of the groups' states
(`groups_of`/`from_groups`). A stacked apply is the family's own
single-table op on a group's flat (n_j*K, ...) view, the row of a
sample being `local * K + row` with `local` its home's index in the
group (`flat_rows`): the vmapped masked scatter of the JAX package
computes the same function, and the llhist apply stays kernel K3, on
the group's device. Out-of-range rows stay out of range, so the ops
drop them as before. The state is updated in place, where the JAX
package donated it; a `*_reset` merge zeroes the drained generation in
place after its merged copy, so it comes back as the next interval's
spare.

A merge reduces each group on its own device, copies the partials to
the store's device (`.to`, which orders the copy after the source
device's queued work) and reduces them once more there; one group's
merge is the one reduction. Each row has one home shard, so the
partials of a row are its value and zeros, and the merged counters,
gauges and registers stay equal to a single table's. The t-digest merge
copies every shard's folded grids to the store's device and recompresses
their concatenation in shard order, as with one group.
"""

from __future__ import annotations

from functools import reduce
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from veneur_tpu_torch.ops import batch_llhist, batch_tdigest, scalars

# the largest n*K a stacked table may have: K3 and the flat rows take an
# int32 row index
MAX_FLAT_ROWS = 2**31 - 1


def home_shards(digest64, n_shards: int) -> np.ndarray:
    """Key digest(s) -> home shard id(s): the contiguous range partition
    home = (digest * n) >> 64, computed in 32-bit halves to stay exact
    in uint64 (the JAX package's function, and the proxy's shard-group
    split)."""
    d = np.asarray(digest64, np.uint64)
    n = np.uint64(n_shards)
    hi = d >> np.uint64(32)
    lo = d & np.uint64(0xFFFFFFFF)
    return ((hi * n + ((lo * n) >> np.uint64(32)))
            >> np.uint64(32)).astype(np.int32)


def range_bounds(n_shards: int) -> List[int]:
    """The digest-space lower bound of every shard's range under
    home_shards: shard i owns [bounds[i], bounds[i+1]) with an implicit
    final bound of 2**64 (ceil(i * 2**64 / n))."""
    return [(i << 64) // n_shards + (1 if (i << 64) % n_shards else 0)
            for i in range(n_shards)]


def check_flat_rows(n_shards: int, num_keys: int) -> None:
    """Raise when a stacked (n, K) table's flat view would pass the int32
    row index that K3 and the flat rows take."""
    if n_shards * num_keys > MAX_FLAT_ROWS:
        raise ValueError(
            f"a stacked table of {n_shards} shards x {num_keys} rows "
            f"passes the int32 row index ({MAX_FLAT_ROWS})")


def flat_rows(home: np.ndarray, rows: np.ndarray,
              num_keys: int) -> np.ndarray:
    """int32 rows of a group's flat (n*K, ...) view: home * K + row for a
    row in [0, K) with a home shard (`home` the shard's index in its
    group), -1 (dropped by every op) otherwise."""
    rows = np.asarray(rows, np.int64)
    home = np.asarray(home, np.int64)
    ok = (rows >= 0) & (rows < num_keys) & (home >= 0)
    return np.where(ok, home * num_keys + rows, -1).astype(np.int32)


def _flat(t: torch.Tensor) -> torch.Tensor:
    """The (n*K, ...) view of a stacked (n, K, ...) tensor."""
    return t.view((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))


def groups_of(state) -> list:
    """A stacked generation as the list of its groups' states."""
    return state if isinstance(state, list) else [state]


def from_groups(states: list):
    """The groups' states as a generation: one group's state as it is
    (the one-device layout), several as their list."""
    return states[0] if len(states) == 1 else states


def _stack(leaf_fn, n_shards: int, num_keys: int, device):
    leaf = leaf_fn(num_keys, device)
    if isinstance(leaf, dict):
        return {k: v.unsqueeze(0).repeat((n_shards,) + (1,) * v.dim())
                for k, v in leaf.items()}
    return leaf.unsqueeze(0).repeat((n_shards,) + (1,) * leaf.dim())


def init_stacked(leaf_fn, plane, num_keys: int):
    """Stacked per-shard state over the plane's groups: for each group,
    `leaf_fn(num_keys, device)` (a tensor or a dict of them) with a
    leading axis of the group's shard count, on the group's device."""
    check_flat_rows(plane.n, num_keys)
    return from_groups([_stack(leaf_fn, len(shards), num_keys, device)
                        for device, shards in zip(plane.groups,
                                                  plane.group_shards)])


def grow_stacked(state, new_cap: int):
    """The key axis (axis 1) of every stacked leaf padded with zeros to
    new_cap."""
    def grow(t):
        check_flat_rows(t.shape[0], new_cap)
        out = torch.zeros((t.shape[0], new_cap) + tuple(t.shape[2:]),
                          dtype=t.dtype, device=t.device)
        out[:, : t.shape[1]] = t
        return out

    def grow_group(g):
        if isinstance(g, dict):
            return {k: grow(v) for k, v in g.items()}
        return grow(g)
    return from_groups([grow_group(g) for g in groups_of(state)])


def zero_(state) -> None:
    """Zero a stacked generation in place (every stacked family's INIT
    values are zeros)."""
    for g in groups_of(state):
        for t in (g.values() if isinstance(g, dict) else (g,)):
            t.zero_()


def _gathered(parts: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
    """Each group's partial on the store's device."""
    return [p.to(device) for p in parts]


# -- stacked applies: the single-table op on the flat view ---------------


def apply_counters_sharded(state, rows, values, rates):
    """A group's (n, K) Kahan pairs += one batch at flat rows
    (kernel-free torch)."""
    scalars.apply_counters({k: _flat(v) for k, v in state.items()}, rows,
                           values, rates)
    return state


def apply_gauges_sharded(state, rows, values):
    """A group's (n, K) last-write-wins at flat rows: each (shard, row)
    keeps its batch's last write, as the vmapped JAX body does."""
    scalars.apply_gauges({k: _flat(v) for k, v in state.items()}, rows,
                         values)
    return state


# the import path's gauge merge is the same last-write-wins apply, each
# stub routed to its home shard's flat row
merge_gauges_sharded = apply_gauges_sharded


def apply_llhist_block_sharded(regs: torch.Tensor, block: np.ndarray):
    """A group's (n, K, BINS_PAD) int32 registers += a
    batch_llhist.pack()ed block whose rows are already flat: one copy and
    one launch of kernel K3 on the group's card (the JAX package's
    vmapped scatter-add)."""
    batch_llhist.apply_packed(_flat(regs), block)
    return regs


def merge_llhist_rows_at(regs: torch.Tensor, shard_ids, rows, in_rows):
    """Import-path whole-row register add over a group's stacked bank:
    incoming row i lands at (shard_ids[i], rows[i]), shard ids local to
    the group; rows outside [0, K) drop."""
    num_keys = regs.shape[1]
    rows = rows.long()
    shard_ids = shard_ids.long()
    keep = (rows >= 0) & (rows < num_keys) & (shard_ids >= 0)
    _flat(regs).index_add_(0, (shard_ids * num_keys + rows)[keep],
                           in_rows[keep])
    return regs


# -- interval merges -------------------------------------------------------


def merge_counters_stacked(state, device
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, K) Kahan pairs -> one (K,) pair on `device`: a sum over
    shards, pure selection under digest routing."""
    parts = [(g["sum"].sum(dim=0), g["comp"].sum(dim=0))
             for g in groups_of(state)]
    if len(parts) == 1:
        return parts[0]
    return (torch.stack(_gathered([p[0] for p in parts], device)).sum(dim=0),
            torch.stack(_gathered([p[1] for p in parts], device)).sum(dim=0))


def merge_counters_stacked_reset(state, device):
    """The flush's merge: the merged pair, then the drained generation
    zeroed in place as the next spare."""
    merged = merge_counters_stacked(state, device)
    zero_(state)
    return merged


def merge_gauges_stacked(state, device
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, K) LWW values + set masks -> merged (value, set) on `device`:
    each row has one home shard, so where(set, value, 0) summed over
    shards is the home shard's last write."""
    parts = [(torch.where(g["set"], g["value"], 0.0).sum(dim=0),
              g["set"].any(dim=0)) for g in groups_of(state)]
    if len(parts) == 1:
        return parts[0]
    value = torch.stack(_gathered([p[0] for p in parts], device)).sum(dim=0)
    return value, torch.stack(_gathered([p[1] for p in parts],
                                        device)).any(dim=0)


def merge_gauges_stacked_reset(state, device):
    merged = merge_gauges_stacked(state, device)
    zero_(state)
    return merged


def merge_llhist_stacked(stacked, device,
                         rows: torch.Tensor = None) -> torch.Tensor:
    """(n, K, BINS_PAD) int32 -> (K, BINS_PAD) int32 on `device`:
    register add over shards. With `rows` (on `device`), only those rows
    are merged (the readout reads the touched rows alone; integer
    addition makes it the same rows of the whole merge)."""
    parts = []
    for g in groups_of(stacked):
        if rows is not None:
            g = torch.index_select(g, 1, rows.to(g.device))
        parts.append(g.sum(dim=0, dtype=torch.int32))
    if len(parts) == 1:
        return parts[0]
    return torch.stack(_gathered(parts, device)).sum(dim=0,
                                                     dtype=torch.int32)


def merge_llhist_stacked_reset(stacked, device,
                               rows: torch.Tensor = None) -> torch.Tensor:
    merged = merge_llhist_stacked(stacked, device, rows)
    zero_(stacked)
    return merged


def merge_hll_stacked(states: Sequence[torch.Tensor], plane,
                      rows: torch.Tensor = None) -> torch.Tensor:
    """Per-shard (K, M) int8 banks -> (K, M) register max on the store's
    device, each group's max taken on its device first; with `rows` (on
    the store's device), the max over those rows of every shard."""
    parts = []
    for group in plane.to_groups(list(states)):
        if rows is not None:
            r = rows.to(group[0].device)
            group = [torch.index_select(st, 0, r) for st in group]
        parts.append(reduce(torch.maximum, group))
    if len(parts) == 1:
        return parts[0]
    return reduce(torch.maximum, _gathered(parts, plane.device))


def merge_histo_stacked(states: Sequence[Dict[str, torch.Tensor]], device
                        ) -> Dict[str, torch.Tensor]:
    """Per-shard t-digest states -> one merged state on `device`: every
    shard's [main | staging] centroids per key, folded on its own device,
    concatenated in shard order and recompressed once (the global
    veneur's re-insertion, reference worker.go:455-457); the scalar
    stats reduce with sum/min/max. The merged state's staging is
    empty."""
    folded = [batch_tdigest._fold_grids(st) for st in states]
    cat_m = torch.cat(_gathered([m for m, _w in folded], device),
                      dim=-1)  # (K, n*2C)
    cat_w = torch.cat(_gathered([w for _m, w in folded], device), dim=-1)
    new_m, new_w = batch_tdigest._recompress(cat_m, cat_w)

    def over(key, how):
        return how(torch.stack(_gathered([st[key] for st in states],
                                         device)), dim=0)

    return {
        "wv": new_m * new_w,
        "weights": new_w,
        "swv": torch.zeros_like(new_w),
        "sweights": torch.zeros_like(new_w),
        "dmin": over("dmin", torch.amin),
        "dmax": over("dmax", torch.amax),
        "drecip": over("drecip", torch.sum),
        "lmin": over("lmin", torch.amin),
        "lmax": over("lmax", torch.amax),
        "lsum": over("lsum", torch.sum),
        "lweight": over("lweight", torch.sum),
        "lrecip": over("lrecip", torch.sum),
    }
