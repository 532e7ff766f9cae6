"""Tag extension: merge operator-configured `extend_tags` into every metric.

Behavioral parity with reference tagging/extend_tags.go: configured tags
override caller tags with the same key prefix (text before the first ':'),
the result is always sorted, empty caller tags are preserved, and empty
configured tags are dropped.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def parse_tag_slice_to_map(tags: Sequence[str]) -> Dict[str, str]:
    """Split "key:value" tags into a dict; bare "key" maps to ""."""
    out: Dict[str, str] = {}
    for tag in tags:
        if not tag:
            continue
        key, sep, value = tag.partition(":")
        out[key] = value if sep else ""
    return out


class ExtendTags:
    __slots__ = ("extra_tags", "extra_tags_map", "_prefixes")

    def __init__(self, tags: Sequence[str] = ()):
        self.extra_tags: List[str] = sorted(t for t in tags if t)
        self.extra_tags_map = parse_tag_slice_to_map(tags)
        self._prefixes = [t.partition(":")[0] for t in tags if t]

    def _should_drop(self, tag: str) -> bool:
        for pre in self._prefixes:
            if tag == pre:
                return True
            if len(pre) < len(tag) and tag.startswith(pre) and tag[len(pre)] == ":":
                return True
        return False

    def extend(self, tags: Sequence[str]) -> List[str]:
        """Return sorted(tags + configured), configured winning key conflicts."""
        if not tags and not self.extra_tags:
            return []
        if not tags:
            return list(self.extra_tags)
        if not self.extra_tags:
            return sorted(tags)
        ret = [t for t in tags if t == "" or not self._should_drop(t)]
        ret.extend(self.extra_tags)
        ret.sort()
        return ret

    def extend_map(self, tags: Dict[str, str]) -> Dict[str, str]:
        ret = dict(tags)
        ret.update(self.extra_tags_map)
        return ret


EMPTY = ExtendTags()
