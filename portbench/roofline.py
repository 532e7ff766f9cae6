"""Peaks of the cards and the least time of each kernel the benchmark
reads, from the bytes and operations its shapes need (the arithmetic of
`chip_smoke.py`'s `_bound` and of each kernel's `bound_bytes`, kept here
so that the yardstick does not move with the program)."""

from __future__ import annotations

from typing import Iterable, Tuple

# device memory rate by card name (NVIDIA data sheets), bytes/s, and the
# float32 rate outside the tensor cores, operations/s
MEM_RATE = {"H100 80GB HBM3": 3.35e12, "H100 PCIe": 2.0e12,
            "H100 NVL": 3.9e12, "H200": 4.8e12}
F32_RATE = {"H100 80GB HBM3": 67e12, "H100 PCIe": 51e12,
            "H100 NVL": 60e12, "H200": 67e12}

K1_SCALARS_IN = 8   # per key: min, max, reciprocal sum and 5 more
K1_OUT_EXTRA = 10   # per key: the packed row's fields beside percentiles
HLL_REGISTERS = 1 << 14


def rate(table: dict, card: str) -> float:
    for key, value in table.items():
        if key in card:
            return value
    raise KeyError(f"no published rate for card {card!r}")


def k1_bytes(num_keys: int, width: int, num_ps: int) -> int:
    """t-digest flush (K1): means and weights (float32) read once, the
    per-key scalars read once, the packed rows written once."""
    return (num_keys * width * 8 + num_keys * K1_SCALARS_IN * 4
            + num_keys * (num_ps + K1_OUT_EXTRA) * 4)


def k1_ops(num_keys: int, width: int, num_ps: int) -> int:
    """Per slot: a cumsum add, a multiply-add for the sum, a compare for
    the count and one per percentile."""
    return num_keys * width * (4 + num_ps)


def k2_bytes(num_rows: int) -> int:
    """HLL estimate (K2): every int8 register read once, every float32
    estimate written once."""
    return num_rows * HLL_REGISTERS + num_rows * 4


def k2_ops(num_rows: int) -> int:
    """Per register: a compare, a power of two and an add."""
    return num_rows * HLL_REGISTERS * 3


def least_seconds(card: str, nbytes: int, nops: int) -> float:
    """The larger of the bytes' and the operations' least times."""
    return max(nbytes / rate(MEM_RATE, card), nops / rate(F32_RATE, card))


def kernel_least_seconds(card: str, kernel: str,
                         shapes: Iterable[Tuple[int, ...]]) -> float:
    """The least time of every launch of `kernel` ("k1" or "k2")."""
    total = 0.0
    for shape in shapes:
        if kernel == "k1":
            total += least_seconds(card, k1_bytes(*shape), k1_ops(*shape))
        else:
            total += least_seconds(card, k2_bytes(*shape), k2_ops(*shape))
    return total


def roofline_pct(run: dict, kernel: str, kernel_name: str):
    """A kernel's share of its roofline over the traced window: None when
    the run was not traced or the kernel did not run on the card."""
    from portbench import devtrace
    measured = devtrace.kernel_seconds(run.get("trace_out"), kernel_name)
    shapes = [shape for k, _t, dev, shape in run.get("launches", ())
              if k == kernel and dev == "cuda"]
    if measured <= 0.0 or not shapes:
        return None
    return kernel_least_seconds(run["card"], kernel, shapes) / measured * 100
