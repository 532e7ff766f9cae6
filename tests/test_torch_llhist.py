"""The llhist family of veneur_tpu_torch against the JAX package: kernel
K3's plain version, the flush readout, and the host binning.

K3's plain version is held to `batch_llhist._apply_batch_jnp` and to
`batch_llhist.apply_batch` (which dispatches to the same jnp path off a
TPU), bit for bit. The Pallas kernel itself (`pallas_llhist._apply_pallas`)
is not compared: it does not trace under the installed JAX
(`jax.experimental.pallas` has no `load`), and on a TPU that failure
latches the jnp path at first use, so the jnp path is what the JAX
package computes. The CUDA kernel is held to the plain version on the
card by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import batch_llhist as jbl
from veneur_tpu.ops import llhist_ref as jref
from veneur_tpu_torch.ops import batch_llhist as tbl
from veneur_tpu_torch.ops import llhist_apply, llhist_ref

PAD_ROW = 2**31 - 1
K = 300  # not a multiple of the TPU kernel's 256-row tile
PS = (0.0, 0.5, 0.99, 1.0)


def _batch(rng, n, num_keys=K):
    """Rows with PAD_ROW padding and rows past the table, bins past the
    padded width, repeated (row, bin) pairs and weights up to 2^20."""
    rows = rng.integers(0, num_keys, n).astype(np.int32)
    bins = rng.integers(0, tbl.BINS_PAD, n).astype(np.int32)
    wts = rng.integers(1, 2**20 + 1, n).astype(np.int32)
    rows[: n // 10] = PAD_ROW
    rows[n // 10: n // 5] = rng.integers(num_keys, 2 * num_keys, n // 10)
    bins[n // 5: n // 4] = rng.integers(tbl.BINS_PAD, 2 * tbl.BINS_PAD,
                                        n // 4 - n // 5)
    rows[-50:], bins[-50:] = rows[-100:-50], bins[-100:-50]  # repeats
    return rows, bins, wts


@pytest.mark.parametrize("jax_fn", [jbl._apply_batch_jnp, jbl.apply_batch],
                         ids=["apply_batch_jnp", "apply_batch"])
def test_k3_plain_is_bit_identical_to_jax(jax_fn):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 1000, (K, tbl.BINS_PAD)).astype(np.int32)
    want = jnp.asarray(base)
    got = torch.from_numpy(base.copy())
    for _ in range(3):  # several batches into one live table
        rows, bins, wts = _batch(rng, 4000)
        want = jax_fn(want, jnp.asarray(rows), jnp.asarray(bins),
                      jnp.asarray(wts))
        tbl.apply_batch(got, *(torch.from_numpy(c) for c in
                               (rows, bins, wts)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k3_plain_wraps_int32_like_jax():
    regs = np.full((2, tbl.BINS_PAD), 2**31 - 10, np.int32)
    rows = np.array([0, 0, 1], np.int32)
    bins = np.array([5, 5, 7], np.int32)
    wts = np.array([2**20, 2**20, 9], np.int32)
    want = np.asarray(jbl._apply_batch_jnp(
        jnp.asarray(regs), jnp.asarray(rows), jnp.asarray(bins),
        jnp.asarray(wts)))
    got = torch.from_numpy(regs.copy())
    llhist_apply.apply_plain(got, *(torch.from_numpy(c)
                                    for c in (rows, bins, wts)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 5] < 0  # wrapped, as the int32 registers of JAX do


def test_k3_drops_negative_indices():
    """Divergence: the JAX scatter reads row -1 as the last row and bin -1
    as the last padded bin (NumPy-style wrap); K3 and its plain version
    drop them. Neither index occurs on either package's path (rows are
    interned ids or PAD_ROW, bins come from bin_index)."""
    regs = torch.zeros((4, tbl.BINS_PAD), dtype=torch.int32)
    cols = (torch.tensor([-1, 1], dtype=torch.int32),
            torch.tensor([3, -1], dtype=torch.int32),
            torch.tensor([7, 9], dtype=torch.int32))
    llhist_apply.apply_plain(regs, *cols)
    assert int(regs.abs().sum()) == 0


@pytest.mark.parametrize("bad", ["dtype", "width", "length", "device",
                                 "columns_noncontiguous",
                                 "regs_noncontiguous", "rank"])
def test_k3_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """apply (and with it the plain version) and apply_cuda's thin check
    raise on what the kernel does not take, each with its reason: the
    cases after "device" go through apply_cuda, whose structural checks
    come before the device check, so they are reached on a CPU tensor."""
    regs = torch.zeros((4, tbl.BINS_PAD), dtype=torch.int32)
    rows = torch.zeros(3, dtype=torch.int32)
    bins = torch.zeros(3, dtype=torch.int32)
    wts = torch.ones(3, dtype=torch.int32)
    match = None
    if bad == "dtype":
        wts = wts.long()
    elif bad == "width":
        regs = torch.zeros((4, 4501), dtype=torch.int32)
    elif bad == "length":
        bins = bins[:2]
    elif bad == "device":
        match = "CUDA device"
    elif bad == "columns_noncontiguous":
        # the plain version takes strided columns, the kernel does not
        bins = torch.zeros(6, dtype=torch.int32)[::2]
        match = "wts must be contiguous"
    elif bad == "regs_noncontiguous":
        regs = torch.zeros((4, 2 * tbl.BINS_PAD), dtype=torch.int32)[:, ::2]
        match = "regs must be contiguous"
    elif bad == "rank":
        rows, match = torch.zeros((3, 1), dtype=torch.int32), "1-D int32"
    with pytest.raises(ValueError, match=match):
        if match is not None:  # a CPU table never reaches the kernel
            llhist_apply.apply_cuda(regs, rows, bins, wts)
        else:
            llhist_apply.apply(regs, rows, bins, wts)


def _chunk(rng, n, num_keys=K):
    """Binned samples as a pump chunk hands them over: interned rows,
    bins inside the live window, weights 1 or 2."""
    return (rng.integers(0, num_keys, n).astype(np.int32),
            rng.integers(0, tbl.BINS, n).astype(np.int32),
            rng.integers(1, 3, n).astype(np.int32))


def _jax_table(cols_list):
    """The JAX package's scatter of the concatenated columns into an
    empty (K, BINS_PAD) table."""
    cat = [np.concatenate([c[j] for c in cols_list]) for j in range(3)]
    return np.asarray(jbl._apply_batch_jnp(
        jnp.zeros((K, tbl.BINS_PAD), jnp.int32), *map(jnp.asarray, cat)))


@pytest.mark.parametrize("pending", [0, 5000])
@pytest.mark.parametrize("chunk", [0, 1, 8191, 8192, 8193, 65536])
def test_llhist_table_whole_chunk_apply(monkeypatch, chunk, pending):
    """A batch that overflows the pending buffer goes to the device with
    the pending samples in ONE apply of the last whole multiple of
    batch_cap; only the remainder stays pending. The table equals the
    JAX package's scatter over the concatenated inputs, bit for bit,
    before and after apply_pending."""
    from veneur_tpu_torch.core.columnstore import LLHistTable
    batch_cap = 8192
    calls = []
    real = llhist_apply.apply

    def counting(regs, rows, bins, wts):
        calls.append(int(rows.shape[0]))
        return real(regs, rows, bins, wts)

    monkeypatch.setattr(llhist_apply, "apply", counting)
    rng = np.random.default_rng(chunk + pending)
    table = LLHistTable(torch.device("cpu"), K, batch_cap=batch_cap)
    first, second = _chunk(rng, pending), _chunk(rng, chunk)
    table.add_batch_binned(*first)
    assert calls == [] and table._n == pending
    table.add_batch_binned(*second)
    total = pending + chunk
    staged = total - total % batch_cap
    assert calls == ([staged] if staged else [])
    assert table._n == total - staged < batch_cap
    cat = [np.concatenate([first[j], second[j]]) for j in range(3)]
    np.testing.assert_array_equal(
        table.state.numpy(), _jax_table([tuple(c[:staged] for c in cat)]))
    assert table.touched[cat[0]].all()
    table.apply_pending()
    assert len(calls) == (staged > 0) + (total > staged)
    assert table._n == 0
    np.testing.assert_array_equal(table.state.numpy(),
                                  _jax_table([first, second]))


def test_llhist_table_copies_caller_columns():
    """add_batch_binned copies the caller's columns before it returns,
    both the part it applies and the part it buffers: a pump chunk's
    arrays die at its release. Overwriting them afterwards changes no
    flushed series."""
    from veneur_tpu_torch.core.columnstore import LLHistTable
    rng = np.random.default_rng(7)
    chunks = [_chunk(rng, 5000), _chunk(rng, 20000), _chunk(rng, 300)]
    originals = [tuple(c.copy() for c in cols) for cols in chunks]
    table = LLHistTable(torch.device("cpu"), K, batch_cap=8192)
    control = LLHistTable(torch.device("cpu"), K, batch_cap=8192)
    for cols, orig in zip(chunks, originals):
        control.add_batch_binned(*(c.copy() for c in orig))
        table.add_batch_binned(*cols)
        for c in cols:  # the caller reuses its memory
            c[:] = rng.integers(0, K, c.shape[0])
    got_out, got_bins, got_touched, _ = table.snapshot_and_reset(ps=PS)
    want_out, want_bins, want_touched, _ = control.snapshot_and_reset(ps=PS)
    np.testing.assert_array_equal(got_touched, want_touched)
    np.testing.assert_array_equal(got_bins, want_bins)
    for key in want_out:
        np.testing.assert_array_equal(got_out[key], want_out[key])
    ref = _jax_table(originals)
    np.testing.assert_array_equal(
        got_bins, ref[np.flatnonzero(got_touched), :tbl.BINS])


def test_pack_returns_a_private_padded_block():
    """pack concatenates the pieces into its own (3, m) block, m a
    multiple of 4, padded with samples the kernel drops; apply_packed
    of the block adds exactly the pieces' samples."""
    a = [np.arange(4, dtype=np.int32) + 10 * j for j in range(3)]
    b = [np.arange(3, dtype=np.int32) + 100 * j for j in range(3)]
    block = tbl.pack([tuple(a), tuple(b)])
    want = [np.r_[np.arange(4) + 10 * j, np.arange(3) + 100 * j]
            for j in range(3)]
    for c in a + b:  # the caller reuses its memory
        c[:] = -1
    assert block.shape == (3, 8) and block.dtype == np.int32
    for j in range(3):
        np.testing.assert_array_equal(block[j, :7], want[j])
    assert block[0, 7] < 0 and block[2, 7] == 0
    regs = torch.zeros((K, tbl.BINS_PAD), dtype=torch.int32)
    tbl.apply_packed(regs, block)
    ref = np.asarray(jbl._apply_batch_jnp(
        jnp.zeros((K, tbl.BINS_PAD), jnp.int32),
        *(jnp.asarray(w.astype(np.int32)) for w in want)))
    np.testing.assert_array_equal(regs.numpy(), ref)


def _registers(rng, num_keys):
    """Bins as ingest makes them: row 0 empty, row 1 one bin, row 2 one
    bin with a large count, the rest a few samples up to thousands, with
    values across the window and both signs."""
    regs = np.zeros((num_keys, tbl.BINS_PAD), np.int32)
    regs[1, 2000] = 1
    regs[2, 4400] = 123456
    for row in range(3, num_keys):
        n = int(rng.integers(1, 3000))
        vals = rng.lognormal(float(rng.uniform(-8, 10)), 2.0, n)
        vals[rng.random(n) < 0.1] *= -1
        np.add.at(regs[row], jref.bin_index(vals),
                  rng.integers(1, 4, n).astype(np.int32))
    return regs


def test_flush_packed_matches_jax():
    regs = _registers(np.random.default_rng(1), 40)
    want = {k: np.asarray(v) for k, v in
            jbl.flush_packed(jnp.asarray(regs), PS).items()}
    got = {k: v.numpy() for k, v in
           tbl.flush_packed(torch.from_numpy(regs), PS).items()}
    np.testing.assert_array_equal(got["count"], want["count"])
    assert got["count"].dtype == np.int32
    # float32 rank and midpoint sums, summed in another order than XLA's
    np.testing.assert_allclose(got["quantiles"], want["quantiles"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-6)
    assert (got["quantiles"][0] == 0).all() and got["sum"][0] == 0
    # a single-bin row reads inside its bin (edges rounded to float32)
    lo = np.float32(llhist_ref.BIN_LEFT[2000])
    hi = np.float32(llhist_ref.BIN_LEFT[2000] + llhist_ref.BIN_WIDTH[2000])
    assert ((got["quantiles"][1] >= lo) & (got["quantiles"][1] <= hi)).all()


def test_flush_packed_without_percentiles():
    regs = _registers(np.random.default_rng(2), 5)
    got = tbl.flush_packed(torch.from_numpy(regs), ())
    assert tuple(got["quantiles"].shape) == (5, 0)


def test_flush_packed_quantiles_match_host_reference():
    """The readout against llhist_ref.quantiles (float64 ranks) within the
    float32 rank rounding."""
    regs = _registers(np.random.default_rng(3), 12)
    got = tbl.flush_packed(torch.from_numpy(regs), PS)["quantiles"].numpy()
    for row in range(12):
        ref = llhist_ref.quantiles(regs[row, :llhist_ref.BINS], PS)
        np.testing.assert_allclose(got[row], ref, rtol=1e-5)


def test_bin_batch_host_matches_jax():
    rng = np.random.default_rng(4)
    vals = np.concatenate([
        rng.lognormal(0, 6, 2000) * rng.choice([-1, 1], 2000),
        [0.0, 1e-10, -1e-10, 1e-9, 1e16, -1e17, 10.0, 99.99999, 100.0]])
    weights = 1.0 / rng.choice([1.0, 0.5, 0.3, 0.1, 1e-10], vals.size)
    for w in (None, weights):
        tb, tw = tbl.bin_batch_host(vals, w)
        jb, jw = jbl.bin_batch_host(vals, w)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tw, jw)
        assert tb.dtype == np.int32 and tw.dtype == np.int32


def test_llhist_ref_copy_matches_jax():
    for name in ("ORDER", "LEFT_SORTED", "WIDTH_SORTED", "BIN_MID",
                 "UPPER_SORTED"):
        np.testing.assert_array_equal(getattr(llhist_ref, name),
                                      getattr(jref, name))
    assert llhist_ref.BINS == jref.BINS == 4501
    assert tbl.BINS_PAD == jbl.BINS_PAD


# -- the flush's compact readout ----------------------------------------------


def _seeded_regs(seed, rows=60):
    """Registers with empty rows, the zero bin, magnitudes collapsed to
    zero or clamped into the top bins, negative values, and one row whose
    total lies past int32."""
    rng = np.random.default_rng(seed)
    regs = np.zeros((rows, tbl.BINS_PAD), np.int32)
    for k in range(rows):
        if k % 7 == 0:
            continue
        vals = np.concatenate([rng.gamma(2.0, 25.0, rng.integers(1, 300)),
                               -rng.lognormal(0.0, 4.0, 10),
                               [0.0, 1e-12, 3e16, -3e16, 1e300]])
        np.add.at(regs[k], llhist_ref.bin_index(vals),
                  rng.integers(1, 1000, vals.size).astype(np.int32))
    regs[5, :200] = 2**24
    return regs, rng


def _compact(regs, ps=PS):
    out = tbl.flush_packed(torch.from_numpy(regs), ps, buckets=True)
    cols = tbl.compact_buckets(out.pop("sorted"))
    assert [c.dtype for c in cols] == [torch.int32, torch.int16, torch.int64]
    return out, tbl.CompactBuckets.from_device(*(c.numpy() for c in cols))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_buckets_equal_the_dense_readout(seed):
    """Each row's nonzero value-sorted bins and exact cumulative counts:
    the flusher's dense cumsum and nonzero mask, row by row; the
    registers rebuilt from them bit for bit; the readout unchanged."""
    regs, rng = _seeded_regs(seed)
    out, cb = _compact(regs)
    dense = regs[:, :llhist_ref.BINS].astype(np.int64)
    c = dense[:, llhist_ref.ORDER]
    csum = np.cumsum(c, axis=1, dtype=np.float64)
    for i in range(regs.shape[0]):
        s, e = cb.offsets[i], cb.offsets[i + 1]
        np.testing.assert_array_equal(cb.bins[s:e], np.flatnonzero(c[i]))
        np.testing.assert_array_equal(cb.cum[s:e].astype(np.float64),
                                      csum[i][c[i] != 0])
    assert cb.offsets[1] == 0 and cb.totals()[0] == 0  # an empty row
    assert cb.totals()[5] > 2**31
    np.testing.assert_array_equal(cb.totals(), dense.sum(axis=1))
    np.testing.assert_array_equal(cb.dense(), dense)
    assert cb.dense().dtype == np.int64
    np.testing.assert_array_equal(
        cb.midpoint_sums(), dense.astype(np.float64) @ llhist_ref.BIN_MID)
    plain = tbl.flush_packed(torch.from_numpy(regs), PS)
    assert set(plain) == set(out)
    for k in plain:
        assert torch.equal(plain[k], out[k]), k
    sel = rng.permutation(regs.shape[0])[:25]
    np.testing.assert_array_equal(cb.take(sel).dense(), dense[sel])
    mask = rng.random(regs.shape[0]) < 0.5
    np.testing.assert_array_equal(cb.take(mask).dense(), dense[mask])


def test_compact_buckets_of_empty_rows():
    for rows in (0, 4):
        _out, cb = _compact(np.zeros((rows, tbl.BINS_PAD), np.int32))
        assert cb.rows == rows and cb.cum.size == 0
        assert cb.dense().shape == (rows, llhist_ref.BINS)
        assert not cb.totals().any()


def _llhist_store_lines(rng):
    lines = []
    for k in range(8):
        vals = np.concatenate([rng.gamma(2.0, 25.0, 40),
                               -rng.lognormal(0.0, 3.0, 5), [0.0, 3e16]])
        lines += [b"cb.%d:%.6g|l|#k:%d" % (k, v, k) for v in vals]
    return lines


def test_llhist_table_compact_snapshot_equals_the_dense_one():
    """The same interval read out with and without `compact`: equal
    readouts, the compact bins rebuild the dense ones, and the copy is
    the smaller."""
    from veneur_tpu_torch.core.columnstore import ColumnStore
    from veneur_tpu_torch.samplers.parser import Parser
    got = []
    for compact in (False, True):
        store, parser = ColumnStore(device="cpu", llhist_capacity=16), \
            Parser()
        for line in _llhist_store_lines(np.random.default_rng(3)):
            parser.parse_metric_fast(line, store.process)
        store.apply_all_pending()
        table = store.llhists
        snap = table.readout(table.swap_out(ps=PS, compact=compact))
        got.append(table.snapshot_finish(snap) + (snap["copy_bytes"],))
        table.recycle(snap)
    (d_out, dense, d_touched, _m, d_bytes), \
        (c_out, cb, c_touched, _m2, c_bytes) = got
    np.testing.assert_array_equal(d_touched, c_touched)
    for k in d_out:
        np.testing.assert_array_equal(d_out[k], c_out[k])
    assert isinstance(cb, tbl.CompactBuckets)
    np.testing.assert_array_equal(cb.dense(), dense)
    assert 0 < c_bytes < d_bytes / 20


def test_forwarded_llhist_rows_are_the_jax_packages_bit_for_bit():
    """A local flush forwards its non-local llhist rows: the registers
    rebuilt from the compact bins equal the JAX package's dense ones, and
    their metricpb wire bytes too."""
    from veneur_tpu.core.columnstore import ColumnStore as JStore
    from veneur_tpu.core.flusher import flush_columnstore_batch as jflush
    from veneur_tpu.forward.convert import forwardable_to_wire as jwire
    from veneur_tpu.samplers.metrics import HistogramAggregates as JAggs
    from veneur_tpu.samplers.parser import Parser as JParser
    from veneur_tpu_torch.core.columnstore import ColumnStore
    from veneur_tpu_torch.core.flusher import flush_columnstore_batch
    from veneur_tpu_torch.forward.convert import forwardable_to_wire
    from veneur_tpu_torch.samplers.metrics import HistogramAggregates
    from veneur_tpu_torch.samplers.parser import Parser
    lines = _llhist_store_lines(np.random.default_rng(5))
    fwds = []
    for store, parser, flush, aggs in (
            (JStore(llhist_capacity=16), JParser(), jflush, JAggs),
            (ColumnStore(device="cpu", llhist_capacity=16), Parser(),
             flush_columnstore_batch, HistogramAggregates)):
        for line in lines:
            parser.parse_metric_fast(line, store.process)
        store.apply_all_pending()
        batch, fwd = flush(store, True, PS, aggs.from_names(["count"]),
                           collect_forward=True)
        assert not batch.bucket_sections
        fwds.append(fwd)
    jfwd, tfwd = fwds
    assert len(tfwd.llhists) == len(jfwd.llhists) == 8
    for (tm, tregs), (jm, jregs) in zip(tfwd.llhists, jfwd.llhists):
        assert tm.name == jm.name
        assert tregs.dtype == jregs.dtype and tregs.shape == jregs.shape
        np.testing.assert_array_equal(tregs, jregs)
    assert forwardable_to_wire(tfwd) == jwire(jfwd)
