"""veneur_tpu_torch counter/gauge ops against veneur_tpu.ops.scalars, bit
for bit, on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from veneur_tpu.ops import scalars as jscalars
from veneur_tpu_torch.core.columnstore import PAD_ROW
from veneur_tpu_torch.ops import scalars as tscalars

K = 37


def _batches(seed, num_batches=4, size=64, pad=9):
    """Batches with repeated rows, rates != 1 and PAD_ROW padding."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_batches):
        rows = rng.integers(0, K, size).astype(np.int32)
        rows[-pad:] = PAD_ROW
        vals = np.round(rng.normal(0, 50, size), 2).astype(np.float32)
        rates = rng.choice([1.0, 0.5, 0.25, 0.1, 0.3], size).astype(
            np.float32)
        out.append((rows, vals, rates))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counters_bit_for_bit(seed):
    jstate = jscalars.init_counters(K)
    tstate = tscalars.init_counters(K, "cpu")
    for rows, vals, rates in _batches(seed):
        jstate = jscalars.apply_counters(jstate, rows, vals, rates)
        tscalars.apply_counters(tstate, _t(rows), _t(vals), _t(rates))
    for key in ("sum", "comp"):
        np.testing.assert_array_equal(tstate[key].numpy(),
                                      np.asarray(jstate[key]))
    np.testing.assert_array_equal(
        tscalars.counter_values(tstate).numpy(),
        np.asarray(jscalars.counter_values(jstate)))


def test_counter_partials_exact_below_2_24():
    """Integer partials stay exact in float32 below 2^24 per key per
    batch, so the order of the card's float atomics cannot change them."""
    rows = np.zeros(4096, np.int32)
    vals = np.full(4096, 4095.0, np.float32)  # 4096 * 4095 < 2^24
    rates = np.ones(4096, np.float32)
    state = tscalars.init_counters(2, "cpu")
    tscalars.apply_counters(state, _t(rows), _t(vals[::-1].copy()),
                            _t(rates))
    assert float(tscalars.counter_values(state)[0]) == 4096 * 4095.0
    assert float(tscalars.counter_values(state)[1]) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gauges_bit_for_bit(seed):
    jstate = jscalars.init_gauges(K)
    tstate = tscalars.init_gauges(K, "cpu")
    for rows, vals, _rates in _batches(seed):
        jstate = jscalars.apply_gauges(jstate, rows, vals)
        tscalars.apply_gauges(tstate, _t(rows), _t(vals))
    np.testing.assert_array_equal(tstate["value"].numpy(),
                                  np.asarray(jstate["value"]))
    np.testing.assert_array_equal(tstate["set"].numpy(),
                                  np.asarray(jstate["set"]))


def test_gauge_last_write_wins_within_batch():
    state = tscalars.init_gauges(3, "cpu")
    rows = _t(np.array([1, 1, 2, 1, PAD_ROW], np.int32))
    vals = _t(np.array([5.0, 6.0, 7.0, 8.0, 9.0], np.float32))
    tscalars.apply_gauges(state, rows, vals)
    assert state["value"].tolist() == [0.0, 8.0, 7.0]
    assert state["set"].tolist() == [False, True, True]
