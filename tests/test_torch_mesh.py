"""The port's multi-card merge plane (veneur_tpu_torch/parallel/mesh.py)
against the JAX package's (veneur_tpu/parallel/mesh.py), on the CPU.

The JAX side runs its shard_map over conftest's virtual 8-device CPU
mesh; the port's eight slots all live on the CPU, where the copies
between slots are no-ops and the per-slot applies and the key-sharded
digest merge run as on the cards. The same numpy-seeded batches
(`make_shard_batches`, the same draws in both packages) go through both.
Tolerances: merged counters, gauges and HLL registers bit for bit
against the JAX merge; the merged t-digest state and its quantiles
within rtol 1e-6 of the port's one-device merge of the same slots
(parallel/collectives.merge_histo_stacked: each key's recompress does
not depend on which card runs it), and within the repo's cross-package
t-digest tolerance (rtol 2e-5, atol 1e-4, tests/test_pallas.py:97) of
the JAX key-sharded merge's quantiles, whose recompress sums in another
order (its centroid means up to 3e-5 apart on these inputs, so each
key's centroid mass is held to 1e-5 and the centroid weights and the
digest and local stats to 1e-6). The JAX side runs jitted, as
__graft_entry__.py's dryrun does. The cases are tests/test_mesh.py's,
each run on both packages."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from veneur_tpu.ops import batch_tdigest as jtd
from veneur_tpu.ops import hll_ref, tdigest_ref
from veneur_tpu.parallel import mesh as jmesh
from veneur_tpu_torch.ops import batch_hll, batch_tdigest
from veneur_tpu_torch.parallel import collectives
from veneur_tpu_torch.parallel import mesh as pmesh

N_DEV = 8
NUM_KEYS = 64
TD_RTOL = 1e-6
K1_TOL = dict(rtol=2e-5, atol=1e-4)


@pytest.fixture(scope="module")
def meshes():
    # no skip: the JAX side needs conftest's virtual CPU mesh
    assert len(jax.devices()) >= N_DEV, (
        f"tests/conftest.py's virtual CPU mesh of {N_DEV} devices is "
        f"missing ({len(jax.devices())} devices)")
    return jmesh.make_mesh(N_DEV), pmesh.make_mesh(N_DEV, devices=["cpu"])


def _jstep(jm):
    return jax.jit(lambda s, b: jmesh.full_step(jm, s, b))


def _both(meshes, batches, num_keys=NUM_KEYS):
    """Both packages' merged state of one fresh step over `batches`; the
    port's per-slot state too."""
    jm, pm = meshes
    _js, jmerged = _jstep(jm)(jmesh.init_sharded_state(jm, num_keys),
                              batches)
    pstate, pmerged = pmesh.full_step(
        pm, pmesh.init_sharded_state(pm, num_keys), batches)
    pmerged["_slots"] = pstate["histos"]
    return jmerged, pmerged


def _histo_batches(data, seed):
    batches = jmesh.make_shard_batches(N_DEV, NUM_KEYS, data.shape[1],
                                       seed=seed)
    batches["h_rows"] = np.zeros(data.shape, np.int32)
    batches["h_vals"] = data
    batches["h_wts"] = np.ones(data.shape, np.float32)
    batches["h_slots"] = np.stack([
        jtd.batch_slots(batches["h_rows"][i], batches["h_vals"][i],
                        batches["h_wts"][i], NUM_KEYS)
        for i in range(N_DEV)])
    return batches


def _flush(histos, ps):
    return batch_tdigest.unpack_flush(batch_tdigest.flush_quantiles_packed(
        histos, ps, fold_staging=False).numpy(), len(ps))


def _assert_digest_like_jax(jmerged, pmerged, ps=(0.25, 0.5, 0.9, 0.99)):
    """The key-sharded merge against the port's one-device merge of the
    same slots (rtol 1e-6) and against the JAX merge (K1's tolerance),
    state and quantiles; returns the port's flush."""
    one = collectives.merge_histo_stacked(pmerged["_slots"], "cpu")
    got = _flush(pmerged["histos"], ps)
    for key, want in jmerged["histos"].items():
        mine = pmerged["histos"][key].numpy()
        np.testing.assert_allclose(mine, one[key].numpy(), rtol=TD_RTOL,
                                   err_msg=key)
        if key == "wv":
            # the centroid means carry the recompress's summation order:
            # each key's total mass is held instead, the means through
            # the quantiles below
            np.testing.assert_allclose(mine.sum(axis=-1),
                                       np.asarray(want).sum(axis=-1),
                                       rtol=1e-5, err_msg=key)
        else:
            np.testing.assert_allclose(mine, np.asarray(want),
                                       rtol=TD_RTOL, err_msg=key)
    want = jtd.flush_quantiles(jmerged["histos"], ps)
    ref = _flush(one, ps)
    for key in ("quantiles", "count", "min", "max"):
        np.testing.assert_allclose(got[key], ref[key], rtol=TD_RTOL,
                                   err_msg=key)
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   err_msg=key, **K1_TOL)
    return got


def test_make_mesh_places_slots_without_a_cpu_fallback(monkeypatch):
    mesh = pmesh.make_mesh(4, devices=["cpu", "cpu"])
    assert mesh.n == 4 and mesh.device == torch.device("cpu")
    assert pmesh.make_mesh(0, devices=["cpu"] * 3).n == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh(4)


def test_shard_batches_are_the_jax_draws():
    got = pmesh.make_shard_batches(N_DEV, NUM_KEYS, 256, seed=9)
    want = jmesh.make_shard_batches(N_DEV, NUM_KEYS, 256, seed=9)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)


class TestCounterMerge:
    def test_psum_exactness(self, meshes):
        batches = jmesh.make_shard_batches(N_DEV, NUM_KEYS, 512, seed=11)
        jmerged, pmerged = _both(meshes, batches)
        want = np.zeros(NUM_KEYS, np.float64)
        contrib = np.trunc(batches["c_vals"].astype(np.float64)
                           / batches["c_rates"].astype(np.float64))
        np.add.at(want, batches["c_rows"].reshape(-1), contrib.reshape(-1))
        got = pmerged["counters"].numpy()
        np.testing.assert_array_equal(got, np.asarray(jmerged["counters"]))
        np.testing.assert_allclose(got.astype(np.float64), want, rtol=1e-6)

    def test_full_step_matches_manual(self, meshes):
        _jm, pm = meshes
        batches = pmesh.make_shard_batches(N_DEV, NUM_KEYS, 128, seed=3)
        state, merged = pmesh.full_step(
            pm, pmesh.init_sharded_state(pm, NUM_KEYS), batches)
        manual = pmesh.merge_shards(pm, pmesh.apply_shard_batches(
            pmesh.init_sharded_state(pm, NUM_KEYS), batches))
        assert torch.equal(merged["counters"], manual["counters"])
        assert len(state["counters"]) == N_DEV


class TestGaugeMerge:
    def test_last_set_shard_wins(self, meshes):
        batches = jmesh.make_shard_batches(N_DEV, NUM_KEYS, 16, seed=5)
        rows = np.full((N_DEV, 16), 2**31 - 1, np.int32)
        vals = np.zeros((N_DEV, 16), np.float32)
        for s in range(N_DEV):
            span = min(16, 8 * (s + 1))
            rows[s, :span] = np.arange(span)
            vals[s, :span] = 1000 * s + np.arange(span)
        batches["g_rows"], batches["g_vals"] = rows, vals
        jmerged, pmerged = _both(meshes, batches)
        got_vals = pmerged["gauges"]["value"].numpy()
        got_set = pmerged["gauges"]["set"].numpy()
        for k in range(16):
            assert got_set[k]
            assert got_vals[k] == 1000 * (N_DEV - 1) + k
        assert not got_set[16:].any()
        np.testing.assert_array_equal(got_vals,
                                      np.asarray(jmerged["gauges"]["value"]))
        np.testing.assert_array_equal(got_set,
                                      np.asarray(jmerged["gauges"]["set"]))

    def test_single_shard_writer(self, meshes):
        batches = jmesh.make_shard_batches(N_DEV, NUM_KEYS, 4, seed=6)
        rows = np.full((N_DEV, 4), 2**31 - 1, np.int32)
        vals = np.zeros((N_DEV, 4), np.float32)
        rows[2, 0], vals[2, 0] = 42, 7.5
        batches["g_rows"], batches["g_vals"] = rows, vals
        jmerged, pmerged = _both(meshes, batches)
        assert bool(pmerged["gauges"]["set"][42])
        assert float(pmerged["gauges"]["value"][42]) == 7.5
        np.testing.assert_array_equal(pmerged["gauges"]["set"].numpy(),
                                      np.asarray(jmerged["gauges"]["set"]))


class TestHLLMerge:
    def test_pmax_matches_scalar_oracle(self, meshes):
        rng = np.random.default_rng(17)
        batches = jmesh.make_shard_batches(N_DEV, NUM_KEYS, 256, seed=17)
        jmerged, pmerged = _both(meshes, batches)
        want = np.zeros((NUM_KEYS, batch_hll.M), np.int8)
        np.maximum.at(want, (batches["s_rows"].reshape(-1),
                             batches["s_idx"].reshape(-1)),
                      batches["s_rho"].reshape(-1).astype(np.int8))
        got = pmerged["sets"].numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(jmerged["sets"]))
        est = batch_hll.estimate(pmerged["sets"]).numpy()
        for k in rng.choice(NUM_KEYS, 8, replace=False):
            oracle = hll_ref.estimate_from_registers(want[k])
            assert est[k] == pytest.approx(oracle, rel=1e-3)

    def test_true_cardinality_accuracy(self, meshes):
        n_members = 20_000
        pos = np.array([hll_ref.pos_val(hll_ref.hash_member(b"member-%d" % i))
                        for i in range(n_members)], np.int64)
        per = n_members // N_DEV
        batches = jmesh.make_shard_batches(N_DEV, NUM_KEYS, per, seed=1)
        batches["s_rows"] = np.zeros((N_DEV, per), np.int32)
        batches["s_idx"] = pos[: N_DEV * per, 0].reshape(
            N_DEV, per).astype(np.int32)
        batches["s_rho"] = pos[: N_DEV * per, 1].reshape(
            N_DEV, per).astype(np.int32)
        jmerged, pmerged = _both(meshes, batches)
        np.testing.assert_array_equal(pmerged["sets"].numpy(),
                                      np.asarray(jmerged["sets"]))
        est = float(batch_hll.estimate(pmerged["sets"])[0])
        assert est == pytest.approx(n_members, rel=0.03)


class TestDigestMerge:
    def test_keysharded_recompress_quantiles(self, meshes):
        rng = np.random.default_rng(23)
        per = 2048
        data = rng.uniform(0.0, 1.0, (N_DEV, per)).astype(np.float32)
        jmerged, pmerged = _both(meshes, _histo_batches(data, seed=2))
        ps = (0.25, 0.5, 0.9, 0.99)
        out = _assert_digest_like_jax(jmerged, pmerged, ps)
        ref = tdigest_ref.MergingDigest()
        for v in data.reshape(-1):
            ref.add(float(v))
        allv = np.sort(data.reshape(-1))
        for j, q in enumerate(ps):
            got = float(out["quantiles"][0, j])
            assert got == pytest.approx(
                float(allv[int(q * (len(allv) - 1))]), abs=0.02), q
            assert got == pytest.approx(ref.quantile(q), abs=0.02), q
        assert float(out["count"][0]) == pytest.approx(N_DEV * per,
                                                       rel=1e-3)
        assert float(out["min"][0]) == pytest.approx(float(allv[0]),
                                                     abs=1e-6)
        assert float(out["max"][0]) == pytest.approx(float(allv[-1]),
                                                     abs=1e-6)

    def test_merge_matches_single_shard_ingest(self, meshes):
        rng = np.random.default_rng(29)
        per = 1024
        data = rng.normal(100.0, 15.0, (N_DEV, per)).astype(np.float32)
        jmerged, pmerged = _both(meshes, _histo_batches(data, seed=4))
        ps = (0.5, 0.9, 0.99)
        got = _assert_digest_like_jax(jmerged, pmerged, ps)
        single = batch_tdigest.init_state(NUM_KEYS, "cpu")
        batch_tdigest.apply_batch(
            single, torch.zeros(N_DEV * per, dtype=torch.int32),
            torch.from_numpy(data.reshape(-1)),
            torch.ones(N_DEV * per))
        want = batch_tdigest.unpack_flush(
            batch_tdigest.flush_quantiles_packed(single, ps).numpy(),
            len(ps))
        for j in range(len(ps)):
            assert float(got["quantiles"][0, j]) == pytest.approx(
                float(want["quantiles"][0, j]), abs=2 * 0.02 * 15)
        assert float(got["count"][0]) == pytest.approx(
            float(want["count"][0]), rel=1e-3)


@pytest.mark.parametrize("n_slots", [3, 8])
def test_full_step_equals_jax_on_every_family(meshes, n_slots):
    """A whole step at the dryrun's mix (every family at once, keys not
    a multiple of the slots for n = 3, so the key-sharded merge pads),
    against the JAX step on as many of its virtual devices."""
    num_keys, batch = 100, 256
    jm = jmesh.make_mesh(n_slots)
    pm = pmesh.make_mesh(n_slots, devices=["cpu"])
    batches = jmesh.make_shard_batches(n_slots, num_keys, batch, seed=31)
    jmerged, pmerged = _both((jm, pm), batches, num_keys)
    np.testing.assert_array_equal(pmerged["counters"].numpy(),
                                  np.asarray(jmerged["counters"]))
    for key in ("value", "set"):
        np.testing.assert_array_equal(pmerged["gauges"][key].numpy(),
                                      np.asarray(jmerged["gauges"][key]))
    np.testing.assert_array_equal(pmerged["sets"].numpy(),
                                  np.asarray(jmerged["sets"]))
    _assert_digest_like_jax(jmerged, pmerged, (0.5, 0.99))
