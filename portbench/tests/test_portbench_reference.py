"""The reference on tiny inputs: HyperLogLog against the port's own
scalar reference, counters, and the t-digest rank slack."""

import numpy as np
import pytest

from portbench.reference import hll
from portbench.reference import statsd as ref


def test_hll_matches_the_scalar_reference():
    from veneur_tpu_torch.ops import hll_ref
    members = [b"m%d" % j for j in range(3000)]
    idx, rho = hll.registers_of(members)
    for j in (0, 1, 2999):
        assert (idx[j], rho[j]) == hll_ref.pos_val(
            hll_ref.hash_member(members[j]))
    for n in (1, 17, 1000, 3000):
        regs = np.zeros(hll.M, np.int8)
        np.maximum.at(regs, idx[:n], rho[:n])
        want = hll_ref.estimate_from_registers(regs)
        nz = regs > 0
        assert hll.estimates([nz.sum()], [np.exp2(
            -regs[nz].astype(float)).sum()])[0] == want


def _traffic(lines):
    """A one-batch pool: (family, key, value index) per line."""
    fam = np.array([[ref.FAMILIES.index(f) for f, _, _ in lines]], np.int8)
    key = np.array([[k for _, k, _ in lines]], np.int32)
    val = np.array([[v for _, _, v in lines]], np.int32)
    values = {"counter": np.array([3.0, 5.0]),
              "gauge": np.array([1.5, -2.25]),
              "timer": np.arange(1.0, 101.0)}
    return ref.Traffic(fam, key, val, values, np.array([1.0, 0.5]),
                       [b"a", b"b"], {"counter": 2, "gauge": 1,
                                      "timer": 1, "set": 1})


def test_counters_gauges_sets():
    t = _traffic([("counter", 0, 0), ("counter", 1, 1), ("counter", 1, 0),
                  ("gauge", 0, 1), ("set", 0, 0), ("set", 0, 0)])
    exp = t.interval(np.array([2]))
    # key 1 at rate 0.5: trunc(5 / 0.5) + trunc(3 / 0.5), twice
    assert list(exp["counter"]["sum"]) == [6.0, 32.0]
    assert list(exp["gauge"]["pairs"]) == [1]
    assert exp["set"]["estimate"][0] == 1.0
    assert not t.interval(np.array([0]))["counter"]["present"].any()


def test_rank_error_of_a_quantile():
    t = _traffic([("timer", 0, v) for v in range(100)])
    timers = t.interval(np.array([1]))["timer"]
    assert timers["min"][0] == 1.0 and timers["max"][0] == 100.0
    keys = np.zeros(3, np.int64)
    qs = np.array([0.5, 0.5, 0.99])
    err = t.rank_error(timers, keys, qs, np.array([50.5, 80.0, 99.2]))
    assert err[0] == 0.0 and err[2] == 0.0
    assert err[1] == pytest.approx(float(ref.k_scale(0.78)
                                         - ref.k_scale(0.5)))


def test_interval_weights():
    log = np.array([[0, 1], [0, 1], [1, 0], [0, 2]])
    assert list(ref.interval_weights(log, 3, 0)) == [0, 2, 1]
    assert list(ref.interval_weights(log, 3, 1)) == [1, 0, 0]
