"""veneur_tpu_torch HLL ops and kernel K2's plain version against
veneur_tpu (batch_hll, the Pallas estimate kernel in interpret mode, and
the scalar reference), on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from veneur_tpu.ops import batch_hll as jhll
from veneur_tpu.ops import hll_ref as jref
from veneur_tpu.ops import pallas_hll as jphll
from veneur_tpu_torch.core.columnstore import PAD_ROW
from veneur_tpu_torch.ops import batch_hll as thll
from veneur_tpu_torch.ops import hll_estimate
from veneur_tpu_torch.ops import hll_ref as tref


def _random_regs(num_rows, seed, fill=0.3):
    rng = np.random.default_rng(seed)
    regs = np.zeros((num_rows, jref.M), np.int8)
    mask = rng.random(regs.shape) < fill
    regs[mask] = rng.integers(1, 51, int(mask.sum()), dtype=np.int8)
    return regs


def test_hash_and_constants_copied_verbatim():
    for member in (b"", b"a", b"member-12345", "ü".encode()):
        assert tref.hash_member(member) == jref.hash_member(member)
        h = tref.hash_member(member)
        assert tref.pos_val(h) == jref.pos_val(h)
    assert (tref._ALPHA, tref._BETA14, tref._BETA14_EZ) == (
        jref._ALPHA, jref._BETA14, jref._BETA14_EZ)


def test_apply_registers_bit_for_bit():
    num_rows = 9
    rng = np.random.default_rng(1)
    jregs = jhll.init_state(num_rows)
    tregs = thll.init_state(num_rows, "cpu")
    for _ in range(3):
        n = 4096
        rows = rng.integers(0, num_rows, n).astype(np.int32)
        rows[-50:] = PAD_ROW
        idx = rng.integers(0, 64, n).astype(np.int32)  # repeats
        rho = rng.integers(1, 40, n).astype(np.int32)
        jregs = jhll.apply_batch(jregs, rows, idx, rho)
        thll.apply_batch(tregs, torch.from_numpy(rows),
                         torch.from_numpy(idx), torch.from_numpy(rho))
    np.testing.assert_array_equal(tregs.numpy(), np.asarray(jregs))
    other = torch.from_numpy(_random_regs(num_rows, seed=2))
    np.testing.assert_array_equal(
        thll.merge(tregs, other).numpy(),
        np.asarray(jhll.merge(np.asarray(jregs), other.numpy())))


@pytest.mark.parametrize("seed,fill", [(0, 0.3), (3, 0.05), (4, 0.9)])
def test_k2_plain_matches_pallas_interpret(seed, fill):
    regs = _random_regs(jphll.TK, seed, fill)
    regs[5] = 0  # an empty row estimates 0
    want = np.asarray(jphll._estimate_pallas(regs, True))
    got = hll_estimate.estimate(torch.from_numpy(regs)).numpy()
    assert hll_estimate.launches == 0  # CPU tensors take the plain path
    # the plain version sums 2^-reg exactly before one float32 rounding;
    # the JAX kernel sums in float32, so the floor may move by 1
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[5] == 0.0


def test_k2_plain_matches_scalar_reference():
    cardinalities = [0, 1, 32, 100, 5000]
    regs = np.zeros((len(cardinalities), jref.M), np.int8)
    for row, n in enumerate(cardinalities):
        h = jref.HLL()
        for i in range(n):
            h.insert(b"m%d-%d" % (row, i))
        regs[row] = h.regs
    got = thll.estimate(torch.from_numpy(regs)).numpy()
    for row, n in enumerate(cardinalities):
        assert got[row] == pytest.approx(
            jref.estimate_from_registers(regs[row]), rel=1e-5), (row, n)
        assert got[row] == pytest.approx(n, rel=0.05, abs=0.5), (row, n)


def test_k2_cuda_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        hll_estimate.estimate_cuda(torch.zeros((2, jref.M), dtype=torch.int8))
    assert hll_estimate.launches == 0
