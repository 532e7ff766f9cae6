"""The sharded serving plane: topology and accounting for the partitioned
column store (torch port of veneur_tpu/parallel/sharded_server.py).

One instance per store owns the shard topology the sharded tables
(core/sharded_tables.py) run on and the digest-home routing function
every family shares: a metric key's 64-bit fnv1a digest picks its home
shard once, at mint time, and every sample and import merge for that key
lands on that shard's slice of the partitioned state. The flush-time
merge is then a selection (parallel/collectives.py), which keeps the
llhist and HLL registers equal to a single table's.

All N shards live on the store's own device. The JAX package spreads
them over the local devices, falls back to a virtual CPU mesh on a
smaller host, and builds no plane (single-device tables) when fewer than
two devices remain; the port does none of that: a store asked for N > 1
shards always gets N shards on its device, and N > 128 raises (a row's
home is stored as int8). A plane of one shard exists only as an elastic
reshard's target (parallel/reshard.py), as in the JAX package, whose
reshard takes any device list.

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


class ShardedServingPlane:
    """Shard topology + per-shard routing accounting, shared by every
    sharded family table of one column store."""

    def __init__(self, n_shards: int, device: torch.device,
                 routing: str = ROUTING_DIGEST):
        if routing not in (ROUTING_DIGEST, ROUTING_ROUNDROBIN):
            raise ValueError(f"unknown shard routing {routing!r}")
        if not 1 <= n_shards <= MAX_SHARDS:
            raise ValueError(f"a sharded plane takes 1..{MAX_SHARDS} "
                             f"shards, got {n_shards}")
        self.device = torch.device(device)
        self.n = int(n_shards)
        # every shard on the store's device
        self.devices = [self.device] * self.n
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


def build_plane(shards: int, device, routing: str = ROUTING_DIGEST
                ) -> Optional[ShardedServingPlane]:
    """The plane for `shards` shards on `device`; None for 0 or 1 (a
    store of single tables). An unknown routing raises either way."""
    if routing not in (ROUTING_DIGEST, ROUTING_ROUNDROBIN):
        raise ValueError(f"unknown shard routing {routing!r}")
    if not shards or shards <= 1:
        return None
    return ShardedServingPlane(int(shards), device, routing=routing)
