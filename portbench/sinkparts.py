"""The parts of a flush's sink time that each metric sink reports in its
`sink:<name>` record of Server.last_flush_timings (its note_egress:
`encode_s`, `send_s` and, where the sink measures it, `gzip_s`)."""

from __future__ import annotations

from typing import Optional


def per_flush(run: dict, part: str) -> Optional[float]:
    """Mean over the window's flushes of `part`, summed over the sinks;
    None where no sink of any flush reports it."""
    ts = run["flush_timings"]
    total, seen = 0.0, False
    for t in ts:
        for key, rec in t.items():
            if key.startswith("sink:") and rec.get(part) is not None:
                total += float(rec[part])
                seen = True
    return total / len(ts) if seen else None
