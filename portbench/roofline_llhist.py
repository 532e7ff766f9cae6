"""The least time of K3, the llhist scatter-add, from the bytes each
launch must move (the arithmetic of `ops/llhist_apply.bound_bytes`, kept
here so that the yardstick does not move with the program): every
sample's row, bin and weight read once, and every distinct register it
adds to read and written once, at the card's memory rate."""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

from portbench import devtrace, roofline

K3_KERNEL = "llhist_apply_kernel"


def k3_bytes(samples: int, registers: int) -> int:
    return samples * 12 + registers * 8


def k3_least_seconds(card: str,
                     launches: Iterable[Tuple[int, int]]) -> float:
    rate = roofline.rate(roofline.MEM_RATE, card)
    return sum(k3_bytes(s, r) for s, r in launches) / rate


def k3_roofline_pct(run: dict) -> Optional[float]:
    """K3's share of its roofline over the traced window: None when the
    run was not traced or K3 did not run on the card."""
    measured = devtrace.kernel_seconds(run.get("trace_out"), K3_KERNEL)
    shapes = [shape for k, _t, dev, shape in run.get("launches", ())
              if k == "k3" and dev == "cuda"]
    if measured <= 0.0 or not shapes:
        return None
    return k3_least_seconds(run["card"], shapes) / measured * 100
