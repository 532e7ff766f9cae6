"""Consistent-hash ring for sharding metrics across global instances.

Semantics parity with the reference's vendored stathat/consistent ring
(used at proxy/destinations/destinations.go:127-141): members are placed
at many virtual points on a ring; `get(key)` walks clockwise from the
key's hash to the first member, so adding/removing one member only remaps
~1/N of keys. Hash is fnv1a-64 (our host keying hash) rather than the
reference's crc32 — both give uniform placement; only intra-cluster
consistency matters, and every veneur-tpu proxy uses the same function.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List

from veneur_tpu_torch.util import fnv

DEFAULT_REPLICAS = 20


class EmptyRingError(LookupError):
    pass


class ConsistentRing:
    def __init__(self, replicas: int = DEFAULT_REPLICAS):
        self.replicas = replicas
        self._lock = threading.RLock()
        self._points: List[int] = []  # sorted hash points
        self._owner: Dict[int, str] = {}  # point -> member
        self._members: set = set()

    def _point(self, member: str, i: int) -> int:
        return fnv.fnv1a_64(f"{i}{member}".encode())

    def add(self, member: str) -> None:
        with self._lock:
            if member in self._members:
                return
            self._members.add(member)
            for i in range(self.replicas):
                pt = self._point(member, i)
                if pt in self._owner:
                    continue  # vanishing chance of 64-bit collision
                self._owner[pt] = member
                bisect.insort(self._points, pt)

    def remove(self, member: str) -> None:
        with self._lock:
            if member not in self._members:
                return
            self._members.discard(member)
            for i in range(self.replicas):
                pt = self._point(member, i)
                if self._owner.get(pt) == member:
                    del self._owner[pt]
                    idx = bisect.bisect_left(self._points, pt)
                    if idx < len(self._points) and self._points[idx] == pt:
                        del self._points[idx]

    def set_members(self, members: List[str]) -> None:
        with self._lock:
            for member in list(self._members - set(members)):
                self.remove(member)
            for member in members:
                self.add(member)

    def members(self) -> List[str]:
        with self._lock:
            return sorted(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def get(self, key: str) -> str:
        return self.get_at(self.point_of(key))

    @staticmethod
    def point_of(key: str) -> int:
        """The key's ring point. Membership-independent, so callers on
        a hot path may cache it per key and skip re-hashing (the Python
        fnv loop dominates a lookup); get_at(point) must give the same
        member get(key) would."""
        return fnv.fnv1a_64(key.encode())

    def get_at(self, point: int) -> str:
        with self._lock:
            if not self._points:
                raise EmptyRingError("empty consistent-hash ring")
            idx = bisect.bisect_right(self._points, point)
            if idx == len(self._points):
                idx = 0
            return self._owner[self._points[idx]]

    def walk_at(self, point: int, max_members: int) -> List[str]:
        """Up to `max_members` DISTINCT members clockwise from `point`,
        primary first — the deterministic failover order: every proxy
        with the same membership walks the same sequence, so a key whose
        primary is sick lands on the same healthy node cluster-wide."""
        with self._lock:
            if not self._points:
                raise EmptyRingError("empty consistent-hash ring")
            out: List[str] = []
            seen = set()
            idx = bisect.bisect_right(self._points, point)
            n = len(self._points)
            for step in range(n):
                member = self._owner[self._points[(idx + step) % n]]
                if member not in seen:
                    seen.add(member)
                    out.append(member)
                    if len(out) >= max_members:
                        break
            return out

    def get_two(self, key: str) -> tuple:
        """The owner and the next distinct member clockwise (for
        replicated sends; reference ring offers Get/GetTwo/GetN)."""
        with self._lock:
            point = self.point_of(key)
            first = self.get_at(point)
            if len(self._members) < 2:
                return first, first
            idx = bisect.bisect_right(self._points, point)
            n = len(self._points)
            for step in range(n):
                member = self._owner[self._points[(idx + step) % n]]
                if member != first:
                    return first, member
            return first, first


def parse_shard_suffix(address: str):
    """Split an optional shard-group suffix off a discovered address:
    ``host:port#3`` -> (``host:port``, 3); plain addresses give
    (address, None) and fall back to hash assignment."""
    base, sep, group = address.rpartition("#")
    if sep and group.isdigit():
        return base, int(group)
    return address, None


class ShardGroupRing:
    """Shard-aware consistent hashing: the 64-bit key-digest space is
    split into G contiguous ranges, each owned by a *shard group* — the
    set of global instances that hold that key range's device shards —
    with an independent ConsistentRing inside every group.

    This is the proxy-tier mirror of the serving mesh's digest-home
    routing (parallel/sharded_server.py): a key's digest picks its
    group exactly the way it picks its home shard on a local's mesh, so
    a global instance only ever receives keys whose partitioned state
    it actually serves. The payoff is failure confinement — ejecting
    one member re-shards ONLY its group's key range onto the group's
    survivors (~1/|group| of 1/G of the keyspace), while every other
    group's assignment is untouched; readmission restores it exactly
    (same virtual points, same ring). Only when a group loses its last
    member does its range spill clockwise to the next non-empty group
    (loud, counted by the caller) — shedding a whole key range at the
    door would be worse than merging it on the wrong shard group.

    Group membership comes from the caller: an explicit `#<g>` suffix
    on the discovered address, or a stable hash of the address. The
    assignment is remembered across remove/add cycles so health
    ejection + readmission can never migrate a member between groups.

    The class is call-compatible with ConsistentRing (`point_of`,
    `get_at`, `walk_at`, `add`, `remove`, `set_members`, `members`), so
    the destination pool and the route caches work unchanged on top of
    either."""

    def __init__(self, groups: int, replicas: int = DEFAULT_REPLICAS):
        if groups < 1:
            raise ValueError("shard group count must be >= 1")
        self.groups = int(groups)
        self._lock = threading.RLock()
        self._rings = [ConsistentRing(replicas) for _ in range(groups)]
        # address -> group, sticky for the address's lifetime (and past
        # it: ejection/readmission must round-trip to the same group)
        self._group_assign: Dict[str, int] = {}
        # member -> RAW `#<g>` discovery-suffix pin (assign()), kept
        # unfolded: a regroup re-derives pins as raw % G' and hash
        # assignments from the address hash, so both stay deterministic
        # functions of (address, G') and a regrouped proxy agrees with
        # a freshly-started one at G'
        self._pinned: Dict[str, int] = {}

    point_of = staticmethod(ConsistentRing.point_of)

    def group_of_point(self, point: int) -> int:
        """Contiguous range partition of the point space: the top bits
        of the 64-bit ring point pick the group, so each group owns one
        digest range (the property that makes 'this group's key range'
        a meaningful unit to re-home or drain)."""
        return (int(point) & 0xFFFFFFFFFFFFFFFF) * self.groups >> 64

    def group_of(self, member: str) -> int:
        with self._lock:
            group = self._group_assign.get(member)
            if group is None:
                group = fnv.fnv1a_64(member.encode()) % self.groups
            return group

    def assign(self, member: str, group: int) -> None:
        """Pin a member to a group (from the `addr#g` discovery suffix).
        Must happen before the member is added; re-pinning a live
        member to a different group is refused (a silent migration
        would leak its old range's keys to the wrong group)."""
        raw = int(group)
        group = raw % self.groups
        with self._lock:
            current = self._group_assign.get(member)
            if current is not None and current != group \
                    and member in self._rings[current]._members:
                raise ValueError(
                    f"{member} is live in shard group {current}; "
                    f"cannot reassign to {group}")
            self._group_assign[member] = group
            self._pinned[member] = raw

    def add(self, member: str) -> None:
        with self._lock:
            group = self.group_of(member)
            self._group_assign[member] = group
            self._rings[group].add(member)

    def remove(self, member: str) -> None:
        with self._lock:
            group = self._group_assign.get(member)
            if group is not None:
                self._rings[group].remove(member)

    def set_members(self, members: List[str]) -> None:
        with self._lock:
            current = set(self.members())
            for member in current - set(members):
                self.remove(member)
            for member in members:
                self.add(member)

    def members(self) -> List[str]:
        with self._lock:
            out: List[str] = []
            for ring in self._rings:
                out.extend(ring.members())
            return sorted(out)

    def group_members(self) -> List[List[str]]:
        """Per-group live membership (ready-state / debug surfaces)."""
        with self._lock:
            return [ring.members() for ring in self._rings]

    def regroup(self, groups: int) -> int:
        """Live G -> G' regroup, the proxy-tier half of an elastic
        reshard (parallel/reshard.py): the serving tier's shard count
        changed, so the door's range partition must follow. Sticky
        pins survive: an explicitly-assigned member re-derives from
        its RAW discovery-suffix pin (raw % G'), a hash-assigned
        member from the same stable address hash — so a G -> G
        round-trip is the identity, and every key whose group's member
        set is unchanged
        keeps its owner EXACTLY (a group's ConsistentRing points are a
        pure function of its membership). Returns the number of
        members whose group id changed."""
        groups = int(groups)
        if groups < 1:
            raise ValueError("shard group count must be >= 1")
        with self._lock:
            live = self.members()
            old_of = {m: self.group_of(m) for m in live}
            replicas = self._rings[0].replicas if self._rings \
                else DEFAULT_REPLICAS
            self.groups = groups
            self._rings = [ConsistentRing(replicas)
                           for _ in range(groups)]
            # re-derive every assignment under the new modulus from
            # its SOURCE (raw suffix pin, or address hash) — both
            # deterministic functions of (address, G'), so a proxy
            # fleet regrouping to the same G' converges on one table
            # without coordination, and a freshly-started proxy at G'
            # agrees with a regrouped one
            moved = 0
            for member in list(self._group_assign):
                pin = self._pinned.get(member)
                if pin is not None:
                    self._group_assign[member] = pin % groups
                else:
                    self._group_assign[member] = \
                        fnv.fnv1a_64(member.encode()) % groups
            for member in live:
                new_group = self._group_assign[member]
                self._rings[new_group].add(member)
                if old_of.get(member) != new_group:
                    moved += 1
            return moved

    def __len__(self) -> int:
        return len(self.members())

    def get(self, key: str) -> str:
        return self.get_at(self.point_of(key))

    def get_at(self, point: int) -> str:
        with self._lock:
            group = self.group_of_point(point)
            for step in range(self.groups):
                ring = self._rings[(group + step) % self.groups]
                try:
                    return ring.get_at(point)
                except EmptyRingError:
                    continue  # whole group down: spill clockwise
            raise EmptyRingError("every shard group is empty")

    def group_siblings(self, member: str, max_members: int) -> List[str]:
        """Deterministic distinct-member walk CONFINED to `member`'s own
        shard group, clockwise from its first virtual point — the hedge
        candidate order. Strictly group-confined because a hedge carries
        a batch of the primary's key range: duplicating it onto another
        group's instance would merge those keys off-range silently.
        Empty when the member has no live group siblings (then don't
        hedge; the breaker/failover path owns recovery). Note the walk
        key is the member's OWN point inside its group's ring — the
        plain walk_at from point_of(member) would start in whatever
        group those point bits land in, not the member's."""
        with self._lock:
            ring = self._rings[self.group_of(member)]
            try:
                walked = ring.walk_at(self.point_of(member), max_members)
            except EmptyRingError:
                return []
            return [m for m in walked if m != member]

    def walk_at(self, point: int, max_members: int) -> List[str]:
        """Deterministic failover order, group-confined first: the
        key's own group's members (primary first), then — only past
        them — neighboring groups clockwise. A sick primary therefore
        re-homes within its shard group, and cross-group spill happens
        only when the walk is allowed to run that deep."""
        with self._lock:
            out: List[str] = []
            group = self.group_of_point(point)
            for step in range(self.groups):
                ring = self._rings[(group + step) % self.groups]
                try:
                    for member in ring.walk_at(
                            point, max_members - len(out)):
                        out.append(member)
                except EmptyRingError:
                    continue
                if len(out) >= max_members:
                    break
            if not out:
                raise EmptyRingError("every shard group is empty")
            return out
