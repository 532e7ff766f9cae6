"""Secret string wrapper that redacts on serialization (port of
veneur_tpu/util/secret.py; reference util/stringSecret.go: marshals as
"REDACTED"). `/config/json` and `/config/yaml` render it redacted."""

from __future__ import annotations


class StringSecret:
    __slots__ = ("value",)

    REDACTED = "REDACTED"

    def __init__(self, value: str = ""):
        self.value = value

    def __bool__(self) -> bool:
        return bool(self.value)

    def __str__(self) -> str:
        return self.REDACTED if self.value else ""

    def __repr__(self) -> str:
        return f"StringSecret({self.REDACTED if self.value else ''!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, StringSecret):
            return self.value == other.value
        return NotImplemented

    def reveal(self) -> str:
        return self.value
