"""The sharded serving plane: topology and accounting for the partitioned
column store (torch port of veneur_tpu/parallel/sharded_server.py).

One instance per store owns the shard topology the sharded tables
(core/sharded_tables.py) run on and the digest-home routing function
every family shares: a metric key's 64-bit fnv1a digest picks its home
shard once, at mint time, and every sample and import merge for that key
lands on that shard's slice of the partitioned state. The flush-time
merge is then a selection (parallel/collectives.py), which keeps the
llhist and HLL registers equal to a single table's.

The shards are spread over placement groups, one device each: shard i
lives in group i mod G. A store on a card places its N shards over the
first min(N, C) of the C visible cards (`local_shard_devices`): shard i
on card i when N <= C, the JAX package's layout. With one group every
shard lives on the store's own device. Each family applies a shard's
samples on its group's device, and a flush reduces each group on its
device before the partials are copied to the store's device for the
last reduction (parallel/collectives.py). Tests and the smoke may pass
the groups themselves (four groups on one device run the multi-card
path on one CPU or one card).

The JAX package falls back to a virtual CPU mesh on a host with fewer
devices than shards and clamps N; the port does neither: a store asked
for N > 1 shards always gets N shards, several to a card when N > C,
and N > 128 raises (a row's home is stored as int8). A plane of one
shard exists only as an elastic reshard's target (parallel/reshard.py),
as in the JAX package, whose reshard takes any device list.

The plane is also the shards' self-telemetry root: `mesh.*` rows
describe the topology, `shard.*` rows the per-shard routing volume, so
an operator sees a skewed key space (one hot shard) on /metrics.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from veneur_tpu_torch.parallel import collectives

ROUTING_DIGEST = "digest"
ROUTING_ROUNDROBIN = "roundrobin"

# a row's home shard is an int8 (the tables' _shard_of)
MAX_SHARDS = 128


def local_shard_devices(n: int, device) -> List[torch.device]:
    """The placement groups of an n-shard store on `device`: the first
    min(n, C) of the C visible cards for a CUDA store, the store's own
    device otherwise. No CPU fallback and no clamp of n (the JAX
    package's `local_shard_devices` has both)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(max(1, min(n, cards)))]


class ShardedServingPlane:
    """Shard topology + per-shard routing accounting, shared by every
    sharded family table of one column store.

    `groups` are the placement groups' devices (default: one group, the
    store's `device`); shard i lives in group i mod G, at index i // G of
    that group's stacked state. `device` is the store's device, where the
    merged state of every flush lands."""

    def __init__(self, n_shards: int, device: torch.device,
                 routing: str = ROUTING_DIGEST, groups=None):
        if routing not in (ROUTING_DIGEST, ROUTING_ROUNDROBIN):
            raise ValueError(f"unknown shard routing {routing!r}")
        if not 1 <= n_shards <= MAX_SHARDS:
            raise ValueError(f"a sharded plane takes 1..{MAX_SHARDS} "
                             f"shards, got {n_shards}")
        self.device = torch.device(device)
        self.n = int(n_shards)
        groups = [self.device] if not groups else list(groups)
        # more groups than shards: the extra groups would hold nothing
        self.groups = [torch.device(d) for d in groups[: self.n]]
        g = len(self.groups)
        # each shard's device, and each group's shards in shard order
        self.devices = [self.groups[i % g] for i in range(self.n)]
        self.group_shards = [list(range(j, self.n, g)) for j in range(g)]
        self.routing = routing
        # per-shard routed-sample counters, keyed by family; written from
        # ingest (under a table's locks) and from the overlapped flush's
        # readout (lock-free), so the adds take their own leaf lock
        self._samples: Dict[str, np.ndarray] = {}
        self._acc_lock = threading.Lock()
        self.batches_dispatched = 0
        self.merge_rounds = 0

    # -- routing ---------------------------------------------------------

    def home(self, digest64: int) -> int:
        """One key's home shard: the contiguous range partition of the
        64-bit digest space (collectives.home_shards)."""
        return ((int(digest64) & 0xFFFFFFFFFFFFFFFF) * self.n) >> 64

    def homes(self, digest64_arr) -> np.ndarray:
        return collectives.home_shards(digest64_arr, self.n)

    # -- placement -------------------------------------------------------

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def split(self, home: np.ndarray):
        """Per-sample home shards -> [(group, local shard index, mask of
        the group's samples)] for every group with a sample; one group
        takes every sample as is (its local index is the home, padding
        -1 included), which keeps the one-group layout's single apply."""
        g = len(self.groups)
        if g == 1:
            return [(0, home, None)]
        out = []
        for j in range(g):
            sel = (home >= 0) & (home % g == j)
            if sel.any():
                out.append((j, home[sel] // g, sel))
        return out

    def to_groups(self, per_shard: list) -> List[list]:
        """A per-shard list cut into each group's shards, in shard
        order."""
        return [[per_shard[i] for i in shards]
                for shards in self.group_shards]

    # -- accounting ------------------------------------------------------

    def note_routed(self, family: str, per_shard_counts) -> None:
        """Fold one dispatch's per-shard sample counts (len n array)."""
        with self._acc_lock:
            acc = self._samples.get(family)
            if acc is None:
                acc = self._samples[family] = np.zeros(self.n, np.int64)
            acc += np.asarray(per_shard_counts, np.int64)
            self.batches_dispatched += 1

    def note_merge_round(self) -> None:
        with self._acc_lock:
            self.merge_rounds += 1

    # -- surfaces --------------------------------------------------------

    def describe(self) -> dict:
        """Topology summary for the startup flight-recorder event and
        /debug surfaces: the device of each shard."""
        return {
            "shards": self.n,
            "routing": self.routing,
            "devices": [f"{d.type}:{0 if d.index is None else d.index}"
                        for d in self.devices],
        }

    def telemetry_rows(self) -> List[tuple]:
        rows: List[tuple] = [
            ("mesh.shards", "gauge", float(self.n), ()),
            ("mesh.merge_rounds", "counter", float(self.merge_rounds), ()),
            ("mesh.batches_dispatched", "counter",
             float(self.batches_dispatched), ()),
        ]
        for family, acc in list(self._samples.items()):
            for shard, count in enumerate(acc.tolist()):
                rows.append(("shard.samples_routed", "counter",
                             float(count),
                             [f"family:{family}", f"shard:{shard}"]))
        return rows


def build_plane(shards: int, device, routing: str = ROUTING_DIGEST,
                groups=None) -> Optional[ShardedServingPlane]:
    """The plane for `shards` shards of a store on `device`, placed over
    `groups` (default: local_shard_devices); None for 0 or 1 (a store of
    single tables). An unknown routing raises either way."""
    if routing not in (ROUTING_DIGEST, ROUTING_ROUNDROBIN):
        raise ValueError(f"unknown shard routing {routing!r}")
    if not shards or shards <= 1:
        return None
    if groups is None:
        groups = local_shard_devices(int(shards), device)
    return ShardedServingPlane(int(shards), device, routing=routing,
                               groups=groups)
