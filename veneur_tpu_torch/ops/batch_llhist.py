"""Batched log-linear histograms over a (key x bin) column store (torch
port of veneur_tpu/ops/batch_llhist.py).

The Circllhist layout (ops/llhist_ref) makes the whole family one dense
(K, BINS_PAD) int32 device table: the host bins values (pure numpy, the
code the scalar reference runs, or the native parser's bit-identical C++
copy) into (row, bin, weight) triples and the device applies them as one
scatter-add, in place (kernel K3, ops/llhist_apply.py). Integer adds are
exact in any order, so the table is bit-identical to the JAX package's.

The flush readout (quantiles + count + midpoint sum) is one pass: gather
the bins in value order, cumulative-sum, binary-search the rank per
(row, percentile), interpolate inside the located bin. It is plain torch
(the JAX package left it to XLA). The same pass can keep the
value-ordered registers for the flush's buckets, which compact_buckets
then reduces, on the device, to each row's nonzero sorted bins and their
exact int64 cumulative counts (CompactBuckets on the host): a flush copies
those instead of every row's dense bins, of which at a deployment's
width over 99 % are zeros.

The table keeps the JAX package's padded width BINS_PAD; bins past
llhist_ref.BINS are never written and every readout indexes through the
value-order gather, which covers only live bins.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

from veneur_tpu_torch.ops import llhist_apply, llhist_ref

BINS = llhist_ref.BINS
# the JAX package's lane-aligned width, kept so tables convert as they are
BINS_PAD = llhist_apply.BINS_PAD

_ORDER = torch.from_numpy(llhist_ref.ORDER.astype(np.int64))
_LEFT_SORTED = torch.from_numpy(llhist_ref.LEFT_SORTED.astype(np.float32))
_WIDTH_SORTED = torch.from_numpy(llhist_ref.WIDTH_SORTED.astype(np.float32))
_BIN_MID = torch.from_numpy(llhist_ref.BIN_MID.astype(np.float32))
_CONSTS: Dict[torch.device, tuple] = {}


def _consts(device: torch.device):
    """ORDER / LEFT_SORTED / WIDTH_SORTED / BIN_MID on `device` (copied
    once per device)."""
    out = _CONSTS.get(device)
    if out is None:
        out = _CONSTS[device] = tuple(
            t.to(device) for t in (_ORDER, _LEFT_SORTED, _WIDTH_SORTED,
                                   _BIN_MID))
    return out


def init_state(num_keys: int, device) -> torch.Tensor:
    return torch.zeros((num_keys, BINS_PAD), dtype=torch.int32,
                       device=device)


def apply_batch(regs: torch.Tensor, rows: torch.Tensor, bins: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Scatter-add a batch of pre-binned samples into `regs` in place
    (kernel K3 on the card). Rows outside [0, K) (PAD_ROW padding) and
    bins outside [0, BINS_PAD) are dropped."""
    return llhist_apply.apply(regs, rows, bins, weights)


def merge_rows(regs: torch.Tensor, rows, in_regs) -> torch.Tensor:
    """Merge whole incoming bin rows (the import path) in place: register
    add. Duplicate rows in one batch accumulate; rows outside [0, K) are
    dropped."""
    rows = rows.long()
    keep = (rows >= 0) & (rows < regs.shape[0])
    regs.index_add_(0, rows[keep], in_regs[keep])
    return regs


def pad_rows_to_device(in_bins) -> np.ndarray:
    """(n, BINS)-or-(n, BINS_PAD) host bins -> (n, BINS_PAD) int32 for
    merge_rows. Counts clip into int32 (a single interval cannot
    overflow it)."""
    arr = np.asarray(in_bins)
    arr = np.clip(arr, 0, np.iinfo(np.int32).max).astype(np.int32)
    if arr.shape[1] == BINS_PAD:
        return arr
    out = np.zeros((arr.shape[0], BINS_PAD), np.int32)
    out[:, :arr.shape[1]] = arr[:, :BINS_PAD]
    return out


def pack(pieces) -> np.ndarray:
    """K3's input for one launch as one private (3, m) int32 block: the
    concatenation of `pieces`, each a (rows, bins, wts) triple of host
    columns, padded to m, a multiple of 4, with samples the kernel drops
    (row -1), so that every column starts on a 16-byte boundary (the
    kernel's vector loads). The caller's columns may be reused as soon
    as this returns."""
    n = sum(len(p[0]) for p in pieces)
    block = np.empty((3, (n + 3) & ~3), np.int32)
    for j in range(3):
        np.concatenate([p[j] for p in pieces], out=block[j, :n])
    block[0, n:], block[1:, n:] = -1, 0
    return block


def apply_packed(regs: torch.Tensor, block: np.ndarray) -> torch.Tensor:
    """Apply a pack()ed block to `regs` in place: ONE host-to-device copy
    of the block (synchronous, from pageable memory; on the CPU the
    tensor shares the block) and one launch of K3."""
    rows, bins, wts = torch.from_numpy(block).to(regs.device)
    return llhist_apply.apply(regs, rows, bins, wts)


def flush_packed(regs: torch.Tensor, ps: Sequence[float],
                 buckets: bool = False) -> Dict[str, torch.Tensor]:
    """One-pass readout of `regs` (K, BINS_PAD) int32:
    {quantiles (K, P) f32, count (K,) int32, sum (K,) f32}, and with
    `buckets` also the value-ordered registers `sorted` (K, BINS) int32,
    compact_buckets' input.

    Op for op the JAX package's flush_packed: the count is the exact
    int32 cumulative sum; ranks and the interpolation run in float32.
    A row with no samples reads all zeros."""
    order, left, width, mid = _consts(regs.device)
    c = torch.index_select(regs, 1, order)            # value-ascending
    csum = torch.cumsum(c, dim=1, dtype=torch.int32)  # exact
    if not buckets:
        del c
    total = csum[:, -1]
    total_f = total.to(torch.float32)
    approx_sum = regs[:, :BINS].to(torch.float32) @ mid
    num_keys = regs.shape[0]
    if ps:
        p = torch.tensor(ps, dtype=torch.float32,
                         device=regs.device).clamp(0.0, 1.0)
        ranks = torch.clamp_min(p[None, :] * total_f[:, None], 0.5)
        idx = torch.searchsorted(csum.to(torch.float32), ranks.contiguous(),
                                 side="left").clamp_max(BINS - 1)
        prev = torch.where(
            idx > 0, torch.gather(csum, 1, (idx - 1).clamp_min(0)), 0)
        cnt = (torch.gather(csum, 1, idx) - prev).to(torch.float32)
        frac = torch.where(cnt > 0, (ranks - prev.to(torch.float32)) / cnt,
                           0.5)
        q = left[idx] + width[idx] * frac.clamp(0.0, 1.0)
        q = torch.where(total[:, None] > 0, q, 0.0)
    else:
        q = torch.zeros((num_keys, 0), dtype=torch.float32,
                        device=regs.device)
    out = {"quantiles": q, "count": total,
           "sum": torch.where(total > 0, approx_sum, 0.0)}
    if buckets:
        out["sorted"] = c
    return out


def compact_buckets(c: torch.Tensor):
    """Each row's nonzero bins of the value-ordered registers `c` (K, B)
    int32, on c's device: (nonzero bins a row (K,) int32, their
    sorted-bin indices (nnz,) int16, their cumulative counts (nnz,) int64,
    summed in int64 so that a row past int32 stays exact), rows ascending
    and bins ascending within a row. The nonzero search waits for c."""
    nz = c != 0
    row_nnz = nz.sum(dim=1)
    flat = torch.nonzero(nz.view(-1)).squeeze(1)
    bins = (flat % c.shape[1]).to(torch.int16)
    if not flat.numel():
        return row_nnz.to(torch.int32), bins, flat
    run = torch.cumsum(c.view(-1)[flat].to(torch.int64), dim=0)
    start = torch.cumsum(row_nnz, dim=0) - row_nnz
    # each row's running total before its first bin
    below = torch.where(start > 0, run[(start - 1).clamp_min(0)], 0)
    return (row_nnz.to(torch.int32), bins,
            run - below[flat // c.shape[1]])


@dataclass
class CompactBuckets:
    """The host form of compact_buckets over `rows` rows: row i's nonzero
    value-sorted bins are bins[offsets[i]:offsets[i + 1]] (indices into
    llhist_ref.UPPER_SORTED, ascending), and cum the exact cumulative
    count through each. A row's total is its last cum (0 for a row with
    no nonzero bin)."""

    offsets: np.ndarray  # (rows + 1,) int64
    bins: np.ndarray     # (nnz,) int64
    cum: np.ndarray      # (nnz,) int64

    @classmethod
    def from_device(cls, row_nnz: np.ndarray, bins: np.ndarray,
                    cum: np.ndarray) -> "CompactBuckets":
        offsets = np.zeros(row_nnz.shape[0] + 1, np.int64)
        np.cumsum(row_nnz, out=offsets[1:])
        return cls(offsets, bins.astype(np.int64), cum.astype(np.int64))

    @property
    def rows(self) -> int:
        return self.offsets.shape[0] - 1

    def totals(self) -> np.ndarray:
        """Each row's total count, exact int64."""
        last = np.zeros(self.rows, np.int64)
        has = np.diff(self.offsets) > 0
        last[has] = self.cum[self.offsets[1:][has] - 1]
        return last

    def row_ids(self) -> np.ndarray:
        """The row of every nonzero bin, (nnz,) int64."""
        return np.repeat(np.arange(self.rows, dtype=np.int64),
                         np.diff(self.offsets))

    def counts(self) -> np.ndarray:
        """Every nonzero bin's own count (its cum less the row's previous
        cum), exact int64."""
        prev = np.empty_like(self.cum)
        prev[:1] = 0
        prev[1:] = self.cum[:-1]
        prev[self.offsets[:-1][np.diff(self.offsets) > 0]] = 0
        return self.cum - prev

    def take(self, sel: np.ndarray) -> "CompactBuckets":
        """The rows `sel` (indices or a boolean mask), in that order."""
        sel = np.arange(self.rows)[sel]
        lens = np.diff(self.offsets)[sel]
        offsets = np.zeros(sel.shape[0] + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        at = (np.repeat(self.offsets[sel] - offsets[:-1], lens)
              + np.arange(offsets[-1]))
        return CompactBuckets(offsets, self.bins[at], self.cum[at])

    def dense(self, dtype=np.int64) -> np.ndarray:
        """The (rows, BINS) registers in bin-id order, exactly the rows
        this was compacted from."""
        out = np.zeros((self.rows, BINS), dtype)
        out[self.row_ids(), llhist_ref.ORDER[self.bins]] = self.counts()
        return out

    def midpoint_sums(self) -> np.ndarray:
        """Each row's float64 midpoint sum, as the JAX package's flusher
        computes it: the float64 registers times llhist_ref.BIN_MID in
        one matrix-vector product, whose summation order (and so last
        bit) follows the BLAS and the rows' count."""
        return self.dense(np.float64) @ llhist_ref.BIN_MID


def bin_batch_host(values, weights=None):
    """Host-side binning for a value batch: (bin ids int32, integer
    weights int32). `weights` are 1/sample_rate floats from the parser;
    they round to the nearest integer count (floor 1) because llhist
    registers are integral — the property exact merges rest on."""
    idx = llhist_ref.bin_index(values)
    if weights is None:
        w = np.ones(idx.shape, np.int32)
    else:
        # clip BEFORE the cast: registers are int32, and 1/rate for an
        # absurd-but-valid rate (@1e-10) would otherwise wrap negative
        w = np.clip(np.rint(np.asarray(weights, np.float64)),
                    1.0, np.iinfo(np.int32).max).astype(np.int32)
    return idx, w
