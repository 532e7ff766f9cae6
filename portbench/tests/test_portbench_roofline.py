"""The roofline's byte counts against PERF.md's kernel table and the
port's own bound_bytes."""

import pytest

from portbench import roofline


def test_k1_bytes():
    assert roofline.k1_bytes(100_000, 256, 3) == pytest.approx(213.2e6,
                                                               rel=1e-3)
    from veneur_tpu_torch.ops import tdigest_flush
    assert roofline.k1_bytes(32768, 128, 4) == tdigest_flush.bound_bytes(
        32768, 128, 4)


def test_k2_bytes():
    assert roofline.k2_bytes(16_384) == pytest.approx(268.5e6, rel=1e-3)
    from veneur_tpu_torch.ops import hll_estimate
    assert roofline.k2_bytes(4096) == hll_estimate.bound_bytes(4096)


def test_least_seconds_at_the_h100_peaks():
    card = "NVIDIA H100 80GB HBM3"
    t = roofline.kernel_least_seconds(card, "k1", [(100_000, 256, 3)])
    assert t == pytest.approx(213.2e6 / 3.35e12, rel=1e-3)
    assert roofline.roofline_pct({"card": card, "trace_out": None,
                                  "launches": []}, "k1", "x") is None
