"""Multi-card merge plane: the two-level aggregation tree over slots on
cards (torch port of veneur_tpu/parallel/mesh.py).

The reference scales horizontally by forwarding mergeable state
(t-digests, HLLs, global counters and gauges) from local veneurs to a
global veneur over gRPC (reference flusher.go:516-591,
worker.go:410-467). Here the same tree maps onto the cards of one host:
every slot aggregates its own ingest shard into a full-width column
state on its card, and the per-interval global merge gathers the slots
over the cards' links:

  counters  -> sum             (merge = addition, samplers.go:143-145)
  gauges    -> last-set-wins   (merge = overwrite, samplers.go:200-202)
  HLL       -> register max    (merge = register max, samplers.go:299-311)
  t-digest  -> key-sharded recompress + gather
               (merge = centroid re-insertion, merging_digest.go:374-389;
               each slot's card recompresses only its K/n key block)

The JAX package runs the merge as one shard_map over a device mesh with
psum, pmax, all_to_all and all_gather. The port runs it as torch copies
between cards, which order themselves after the work queued on the
source card: the all_to_all is each slot's card taking its key block of
every slot's grids, the all_gather the blocks copied to the first
slot's card, where the merged state lands. Slot i lives on card
i mod min(n, C) of the C visible cards (the placement rule of
parallel/sharded_server.py), or on the devices the caller names; there
is no CPU fallback.

Cross-host hops between tiers use the gRPC forward plane
(veneur_tpu_torch.forward); this module covers the intra-host path. No
server reaches it: it is the multi-card dryrun the smoke holds against
a single-device oracle.
"""

from __future__ import annotations

from functools import reduce
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from veneur_tpu_torch.ops import batch_hll, batch_tdigest, scalars

FAMILIES = ("counters", "gauges", "histos", "sets")


class Mesh:
    """n slots, slot i on `devices[i]`; the merged state lands on the
    first slot's device."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one slot")
        self.n = len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_mesh(n_devices: int = 0, devices: Optional[Sequence] = None
              ) -> Mesh:
    """`n_devices` slots (0: one per visible card) over the visible cards,
    slot i on card i mod min(n, C), or over `devices` (slot i on
    devices[i mod len(devices)]). Without CUDA and without `devices` it
    raises: the JAX package falls back to its virtual CPU mesh, the port
    does not."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "the slots' devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    return Mesh([devices[i % min(n, len(devices))] for i in range(n)])


def init_sharded_state(mesh: Mesh, num_keys: int) -> Dict[str, list]:
    """Per-slot column-store state, family -> one state per slot on the
    slot's device. Every slot holds the same key->row layout (the row
    ids are the global tier's)."""
    return {
        "counters": [scalars.init_counters(num_keys, d)
                     for d in mesh.devices],
        "gauges": [scalars.init_gauges(num_keys, d) for d in mesh.devices],
        "histos": [batch_tdigest.init_state(num_keys, d)
                   for d in mesh.devices],
        "sets": [batch_hll.init_state(num_keys, d) for d in mesh.devices],
    }


def _merge_digest_keysharded(mesh: Mesh, histos: List[dict]) -> dict:
    """Merge every slot's centroid grids, the global veneur re-inserting
    each local digest's centroids (worker.go:455-457), key-sharded: slot
    j's card takes the j-th K/n key block of every slot's folded grids
    (the all_to_all), concatenates them in slot order and recompresses
    its K/n rows; the compact blocks are gathered to the first slot's
    card in block order (the all_gather). The d* and l* stats reduce
    there with min, max or sum."""
    n = mesh.n
    num_keys = histos[0]["wv"].shape[0]
    kp = -(-num_keys // n)  # keys per slot after the scatter
    folded = []
    for st in histos:
        m, w = batch_tdigest._fold_grids(st)  # (K, 2C)
        pad = kp * n - num_keys
        if pad:
            m = torch.nn.functional.pad(m, (0, 0, 0, pad))
            w = torch.nn.functional.pad(w, (0, 0, 0, pad))
        folded.append((m, w))
    blocks_m, blocks_w = [], []
    for j, device in enumerate(mesh.devices):
        lo, hi = j * kp, (j + 1) * kp
        cat_m = torch.cat([m[lo:hi].to(device) for m, _w in folded],
                          dim=-1)  # (kp, n*2C)
        cat_w = torch.cat([w[lo:hi].to(device) for _m, w in folded],
                          dim=-1)
        local_m, local_w = batch_tdigest._recompress(cat_m, cat_w)
        blocks_m.append(local_m.to(mesh.device))
        blocks_w.append(local_w.to(mesh.device))
    new_m = torch.cat(blocks_m)[:num_keys]
    new_w = torch.cat(blocks_w)[:num_keys]

    def over(key, how):
        return how(torch.stack([st[key].to(mesh.device) for st in histos]),
                   dim=0)

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


def merge_shards(mesh: Mesh, state: Dict[str, list]) -> Dict:
    """Merge every slot's interval state into the global view on the
    first slot's device: the flush-time 'forward + import' of the
    reference collapsed into copies between cards."""
    dev = mesh.device
    counters = torch.stack([scalars.counter_values(c).to(dev)
                            for c in state["counters"]]).sum(dim=0)

    # last-set-wins across slots: the highest-indexed slot that set it
    gsets = torch.stack([g["set"].to(dev) for g in state["gauges"]])
    gvals = torch.stack([g["value"].to(dev) for g in state["gauges"]])
    idx = torch.arange(1, mesh.n + 1, dtype=torch.int32,
                       device=dev)[:, None]
    rank = torch.where(gsets, idx, 0)
    best = rank.amax(dim=0)
    contrib = torch.where(rank == best.clamp(min=1)[None, :], gvals, 0.0)
    gauges = {"value": contrib.sum(dim=0), "set": best > 0}

    sets = reduce(torch.maximum, [s.to(dev) for s in state["sets"]])
    histos = _merge_digest_keysharded(mesh, state["histos"])
    return {"counters": counters, "gauges": gauges, "sets": sets,
            "histos": histos}


def _slot_batch(batches: Dict[str, np.ndarray], i: int, device
                ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v[i])).to(device)
            for k, v in batches.items()}


def apply_shard_batches(state: Dict[str, list],
                        batches: Dict[str, np.ndarray]) -> Dict[str, list]:
    """Apply per-slot COO batches (leading axis = slot) to each slot's
    state on its device, in place: pure data parallelism, no copy
    between cards."""
    for i, (c, g, h, s) in enumerate(zip(*(state[f] for f in FAMILIES))):
        b = _slot_batch(batches, i, c["sum"].device)
        scalars.apply_counters(c, b["c_rows"], b["c_vals"], b["c_rates"])
        scalars.apply_gauges(g, b["g_rows"], b["g_vals"])
        batch_tdigest.apply_batch(h, b["h_rows"], b["h_vals"], b["h_wts"],
                                  b["h_slots"])
        batch_hll.apply_batch(s, b["s_rows"], b["s_idx"], b["s_rho"])
    return state


def make_shard_batches(n: int, num_keys: int, batch: int,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic per-slot sample batches (for the dryrun), the JAX
    package's draws from the same seed."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    h_rows = rng.integers(0, num_keys, (n, batch)).astype(np.int32)
    h_vals = rng.normal(100, 15, (n, batch)).astype(f32)
    h_wts = np.ones((n, batch), f32)
    h_slots = np.stack(
        [batch_tdigest.batch_slots(h_rows[i], h_vals[i], h_wts[i], num_keys)
         for i in range(n)])
    return {
        "c_rows": rng.integers(0, num_keys, (n, batch)).astype(np.int32),
        "c_vals": rng.random((n, batch)).astype(f32) * 10,
        "c_rates": np.ones((n, batch), f32),
        "g_rows": rng.integers(0, num_keys, (n, batch)).astype(np.int32),
        "g_vals": rng.random((n, batch)).astype(f32),
        "h_rows": h_rows,
        "h_vals": h_vals,
        "h_wts": h_wts,
        "h_slots": h_slots,
        "s_rows": rng.integers(0, num_keys, (n, batch)).astype(np.int32),
        "s_idx": rng.integers(0, batch_hll.M, (n, batch)).astype(np.int32),
        "s_rho": rng.integers(1, 30, (n, batch)).astype(np.int32),
    }


def full_step(mesh: Mesh, state: Dict[str, list],
              batches: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """One full sharded aggregation step: per-slot batch apply (data
    parallel) followed by the global merge."""
    state = apply_shard_batches(state, batches)
    merged = merge_shards(mesh, state)
    return state, merged
