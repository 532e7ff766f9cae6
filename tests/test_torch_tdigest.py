"""veneur_tpu_torch t-digest ops and kernel K1's plain version against
veneur_tpu (batch_tdigest, and the Pallas flush kernel in interpret
mode), on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from veneur_tpu.ops import batch_tdigest as jbtd
from veneur_tpu.ops import pallas_tdigest as jptd
from veneur_tpu_torch.core.columnstore import PAD_ROW
from veneur_tpu_torch.ops import batch_tdigest as tbtd
from veneur_tpu_torch.ops import tdigest_flush

# float32 reduction order differs between the packages (and the kernel):
# the tolerance of tests/test_pallas.py's kernel parity checks
TOL = dict(rtol=2e-5, atol=1e-4, equal_nan=True)
PS = (0.5, 0.9, 0.99)


def _corpus(num_keys, seed, num_batches=3, size=512):
    """Batches over `num_keys` rows with a dense key (> C samples in one
    batch), sparse keys, empty rows, fractional weights and padding."""
    rng = np.random.default_rng(seed)
    batches = []
    for b in range(num_batches):
        rows = rng.integers(0, num_keys - 3, size).astype(np.int32)
        rows[: 200] = 1  # dense in one batch: k-bucket slots, then full
        rows[-7:] = PAD_ROW
        vals = rng.gamma(2.0, 10.0, size).astype(np.float32)
        wts = (1.0 / rng.choice([1.0, 0.5, 0.25, 0.1], size)).astype(
            np.float32)
        batches.append((rows, vals, wts))
    return batches


def _to_t(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def test_apply_compact_flush_matches_jax():
    num_keys = 50
    jstate = jbtd.init_state(num_keys)
    tstate = tbtd.init_state(num_keys, "cpu")
    jcounts = np.zeros(num_keys, np.int32)
    tcounts = np.zeros(num_keys, np.int32)
    compacts = 0
    for rows, vals, wts in _corpus(num_keys, seed=4):
        jslots, joverflow = jbtd.host_slots(rows, vals, wts, jcounts)
        tslots, toverflow = tbtd.host_slots(rows, vals, wts, tcounts)
        assert joverflow == toverflow
        np.testing.assert_array_equal(tslots, jslots)
        if joverflow:
            compacts += 1
            jstate = jbtd.compact(jstate)
            tbtd.compact(tstate)
            jcounts[:] = 0
            tcounts[:] = 0
            jslots, _ = jbtd.host_slots(rows, vals, wts, jcounts)
            tslots, _ = tbtd.host_slots(rows, vals, wts, tcounts)
        jstate = jbtd.apply_batch(jstate, rows, vals, wts, jslots)
        tbtd.apply_batch(tstate, *(torch.from_numpy(a) for a in
                                   (rows, vals, wts, tslots)))
        for k, v in jstate.items():
            np.testing.assert_allclose(tstate[k].numpy(), np.asarray(v),
                                       **TOL)
    assert compacts >= 1  # the dense key forced a compact
    want = np.asarray(jbtd.flush_quantiles_packed(jstate, PS))
    got = tbtd.flush_quantiles_packed(tstate, PS).numpy()
    assert got.shape == want.shape == (num_keys, len(PS) + 10)
    np.testing.assert_allclose(got, want, **TOL)
    # empty rows: NaN quantiles and hmean, zero count
    assert np.isnan(got[-1, :len(PS)]).all() and got[-1, len(PS)] == 0.0


def test_compact_then_flush_without_staging_matches_jax():
    num_keys = 20
    rows, vals, wts = _corpus(num_keys, seed=9, num_batches=1)[0]
    jstate = jbtd.compact(jbtd.apply_batch(jbtd.init_state(num_keys),
                                           rows, vals, wts))
    tstate = tbtd.init_state(num_keys, "cpu")
    tbtd.apply_batch(tstate, *(torch.from_numpy(a)
                               for a in (rows, vals, wts)))
    tbtd.compact(tstate)
    want = np.asarray(jbtd.flush_quantiles_packed(jstate, PS,
                                                  fold_staging=False))
    got = tbtd.flush_quantiles_packed(tstate, PS, fold_staging=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    unpacked = tbtd.unpack_flush(got.numpy(), len(PS))
    want_unpacked = jbtd.unpack_flush(want, len(PS))
    for k in want_unpacked:
        np.testing.assert_allclose(unpacked[k], want_unpacked[k], **TOL)


def _sorted_inputs(num_keys, width, seed):
    """Mean-sorted centroids as the flush hands them to K1: a JAX state's
    _sorted_centroids at width 2C (staging folded) or C (main only), with
    empty and single-centroid rows."""
    rng = np.random.default_rng(seed)
    rows, vals, wts = [], [], []
    for row in range(num_keys - 2):  # the last two rows stay empty
        n = 1 if row % 7 == 0 else int(rng.integers(2, 300))
        rows += [row] * n
        vals += rng.normal(rng.uniform(-50, 50), rng.uniform(0.1, 20),
                           n).tolist()
        wts += (1.0 / rng.choice([1.0, 0.5, 0.25], n)).tolist()
    rows = np.asarray(rows, np.int32)
    order = np.argsort(rows, kind="stable")
    state = jbtd.apply_batch(jbtd.init_state(num_keys), rows[order],
                             np.asarray(vals, np.float32)[order],
                             np.asarray(wts, np.float32)[order])
    fold = width == 2 * jbtd.C
    if not fold:
        state = jbtd.compact(state)
    sm, sw = jbtd._sorted_centroids(state, fold)
    # writable host copies: torch.from_numpy refuses read-only arrays
    return np.array(sm), np.array(sw), np.array(jptd.scalars_of(state))


@pytest.mark.parametrize("width", [2 * tbtd.C, tbtd.C])
def test_k1_plain_matches_pallas_interpret(width):
    num_keys = jptd.BK
    sm, sw, scal = _sorted_inputs(num_keys, width, seed=width)
    assert sm.shape == (num_keys, width)
    want = np.asarray(jptd._flush_pallas(sm, sw, scal, PS, True))
    # the port takes any K: a ragged 100 rows of the same inputs
    k = 100
    got = tdigest_flush.flush_packed(
        torch.from_numpy(sm[:k].copy()), torch.from_numpy(sw[:k].copy()),
        torch.from_numpy(scal[:k].copy()), PS)
    assert tdigest_flush.launches == 0  # CPU tensors take the plain path
    np.testing.assert_allclose(got.numpy(), want[:k], **TOL)
    # single-centroid rows interpolate between dmin and dmax
    assert np.isfinite(got.numpy()[0, :len(PS)]).all()
    full = tdigest_flush.flush_packed(
        torch.from_numpy(sm), torch.from_numpy(sw),
        torch.from_numpy(scal), PS).numpy()
    np.testing.assert_allclose(full, want, **TOL)
    assert np.isnan(full[-2:, :len(PS)]).all()


def test_k1_cuda_wrapper_rejects_cpu_tensors():
    sm = torch.zeros((4, 128))
    scal = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tdigest_flush.flush_packed_cuda(sm, sm, scal, PS)
    assert tdigest_flush.launches == 0


def test_reset_state_restores_init_values():
    state = tbtd.init_state(3, "cpu")
    tbtd.apply_batch(state, torch.tensor([0, 2], dtype=torch.int32),
                     torch.tensor([1.5, -2.0]), torch.tensor([1.0, 2.0]))
    tbtd.reset_state_(state)
    fresh = tbtd.init_state(3, "cpu")
    for k in fresh:
        assert torch.equal(state[k], fresh[k]), k
