"""DogStatsD wire-format rendering: the single source of truth for
`name:value|type|@rate|#tags` packets, events, and service checks.

This is the emit side of the grammar that samplers/parser.py consumes
(reference cmd/veneur-emit/main.go:594-930 createMetric / event / service
check packet builders). Shared by veneur-emit, veneur-prometheus, the
scopedstatsd self-metrics client, and the prometheus repeater sink.
"""

from __future__ import annotations

from typing import List


def render_metric_packet(name: str, value, mtype: str,
                         tags: List[str], rate: float = 1.0) -> bytes:
    parts = [f"{name}:{value}|{mtype}"]
    if rate != 1.0:
        parts.append(f"@{rate}")
    if tags:
        parts.append("#" + ",".join(tags))
    return "|".join(parts).encode()


def render_event_packet(title: str, text: str, tags: List[str],
                        aggregation_key: str = "", priority: str = "",
                        source_type: str = "", alert_type: str = "",
                        hostname: str = "", timestamp: str = "") -> bytes:
    header = f"_e{{{len(title.encode())},{len(text.encode())}}}:{title}|{text}"
    sections = []
    if timestamp:
        sections.append(f"d:{timestamp}")
    if aggregation_key:
        sections.append(f"k:{aggregation_key}")
    if priority:
        sections.append(f"p:{priority}")
    if source_type:
        sections.append(f"s:{source_type}")
    if alert_type:
        sections.append(f"t:{alert_type}")
    if hostname:
        sections.append(f"h:{hostname}")
    if tags:
        sections.append("#" + ",".join(tags))
    return ("|".join([header] + sections)).encode()


def render_service_check_packet(name: str, status: int, tags: List[str],
                                message: str = "",
                                hostname: str = "",
                                timestamp: str = "") -> bytes:
    parts = [f"_sc|{name}|{status}"]
    if timestamp:
        parts.append(f"d:{timestamp}")
    if hostname:
        parts.append(f"h:{hostname}")
    if tags:
        parts.append("#" + ",".join(tags))
    if message:
        parts.append(f"m:{message}")
    return "|".join(parts).encode()
