"""Batched t-digest over a (key x centroid) column store (torch port of
veneur_tpu/ops/batch_tdigest.py).

The whole table of digests is dense tensors — means/weights grids of shape
(K, C) plus per-key scalar stats — and ingestion is batched:

  1. Each sample RANK-PARKS into the per-key staging grid at a slot the
     host computes (`host_slots`: the key's staged count plus its
     within-batch rank), so every staged sample keeps its exact
     (value, weight) — the analog of the reference's raw temp buffer
     (merging_digest.go:115-140).
  2. Keys dense within one batch (> C samples) bucket by their
     batch-local weighted midpoint quantile instead.
  3. Before a key's staging could overflow, and before a flush, `compact`
     folds staging into the main grid: sort [main | staging] by mean,
     bucket by the arcsine k-scale of the combined midpoint quantiles
     (merging_digest.go:259-262) and segment-reduce the contiguous
     buckets through prefix sums and a sorted search.

State updates happen IN PLACE on the state dict's tensors, where the JAX
package donated the buffers to its jitted kernels. Rows outside [0, K) are
dropped (see ops/scalars.py for why torch needs the explicit masking).

The flush's post-sort interpolation is kernel K1 (ops/tdigest_flush.py),
in the plain flush and in the forwarding flush (flush_export_packed),
whose recompress of the same sorted arrays stays torch. The import path
merges serialized digests with merge_centroid_rows (torch; plain XLA in
the JAX package).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from veneur_tpu_torch.ops import tdigest_flush
from veneur_tpu_torch.ops.tdigest_flush import FLUSH_SCALARS

COMPRESSION = 100.0  # parity with reference samplers/samplers.go:350
C = 128  # centroid slots per key; >= COMPRESSION buckets

_INF = float("inf")

# per-key scalar stats and their initial values; d* follow the digest, l*
# only locally-ingested samples (reference samplers.go:316-343)
SCALAR_INIT = {"dmin": _INF, "dmax": -_INF, "drecip": 0.0, "lmin": _INF,
               "lmax": -_INF, "lsum": 0.0, "lweight": 0.0, "lrecip": 0.0}
GRIDS = ("wv", "weights", "swv", "sweights")


def init_state(num_keys: int, device) -> Dict[str, torch.Tensor]:
    """Fresh digest table: wv/weights are the main grid (per-slot sum of
    weight*value, and weight), swv/sweights the raw-sample staging grid
    (the host tracks per-key slot occupancy); `compact` folds staging
    into the main grid."""
    state = {k: torch.zeros((num_keys, C), dtype=torch.float32,
                            device=device) for k in GRIDS}
    for k, v in SCALAR_INIT.items():
        state[k] = torch.full((num_keys,), v, dtype=torch.float32,
                              device=device)
    return state


def reset_state_(state: Dict[str, torch.Tensor]) -> None:
    """Rewrite a drained generation to init_state's values in place (the
    JAX package donated it to a reset kernel). Zeros alone would corrupt
    the ±inf extrema into fabricated 0.0 values."""
    for k in GRIDS:
        state[k].zero_()
    for k, v in SCALAR_INIT.items():
        state[k].fill_(v)


def _k_scale(q: torch.Tensor) -> torch.Tensor:
    """Arcsine k-scale index (parity with merging_digest.go:259-262)."""
    q = q.clamp(0.0, 1.0)
    return COMPRESSION * (torch.asin(2.0 * q - 1.0) / math.pi + 0.5)


def host_ranks(rows: np.ndarray) -> np.ndarray:
    """Within-batch ordinal of each sample among samples of the same row
    (host-side, vectorized: one stable argsort + grouped arange)."""
    order = np.argsort(rows, kind="stable")
    sr = rows[order]
    n = sr.shape[0]
    if n == 0:
        return np.zeros(0, np.int32)
    is_start = np.empty(n, bool)
    is_start[0] = True
    np.not_equal(sr[1:], sr[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    seg = np.cumsum(is_start) - 1
    ranks_sorted = np.arange(n, dtype=np.int32) - starts[seg].astype(np.int32)
    ranks = np.empty(n, np.int32)
    ranks[order] = ranks_sorted
    return ranks


def host_slots(rows, values, weights, counts):
    """Staging slots for a COO batch (host-side; numpy throughout).

    Sparse keys (<= C samples in this batch) RANK-PARK: slot = the key's
    staged count so far (`counts`) + within-batch ordinal, keeping every
    staged sample exact. Keys dense within this batch (> C samples)
    fall back to batch-local weighted-midpoint-quantile k-buckets and are
    marked full so the next touch forces a compact.

    Returns (slots, overflow). overflow=True means some key's staged
    count plus this batch would exceed C: the caller must `compact`
    (zeroing `counts`) and call again; `counts` is not mutated then.
    """
    cap = counts.shape[0]
    out = np.zeros(rows.shape[0], np.int32)
    valid = rows < cap
    r = rows[valid]
    n = r.shape[0]
    if n == 0:
        return out, False
    g = np.bincount(r, minlength=cap).astype(np.int32)
    if bool(np.any((counts > 0) & (counts + g > C))):
        return out, True
    dense = g > C
    if not dense.any():
        out[valid] = counts[r] + host_ranks(r)
        counts += g
        return out, False

    v = np.asarray(values)[valid]
    w = np.asarray(weights)[valid]
    order = np.lexsort((v, r))
    sr, sw = r[order], w[order]
    is_start = np.empty(n, bool)
    is_start[0] = True
    np.not_equal(sr[1:], sr[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    ends = np.r_[starts[1:], n]
    seg = np.cumsum(is_start) - 1
    cw = np.cumsum(sw)
    gbase = np.where(starts > 0, cw[np.maximum(starts - 1, 0)], 0.0)
    gtot = cw[ends - 1] - gbase
    prefix = cw - sw - gbase[seg]
    q_mid = (prefix + 0.5 * sw) / np.maximum(gtot[seg], 1e-30)
    kq = COMPRESSION * (
        np.arcsin(np.clip(2.0 * q_mid - 1.0, -1.0, 1.0)) / math.pi + 0.5)
    qslot = np.clip(np.floor(kq).astype(np.int32), 0, C - 1)
    ranks_sorted = (np.arange(n, dtype=np.int32)
                    - starts[seg].astype(np.int32))
    park_sorted = counts[sr] + ranks_sorted
    slot_sorted = np.where(dense[sr], qslot, park_sorted)
    sl = np.empty(n, np.int32)
    sl[order] = slot_sorted
    out[valid] = sl
    counts += g
    counts[dense] = C  # full: next touch of a dense key forces a compact
    return out, False


def batch_slots(rows, values, weights, num_keys):
    """Slots for a standalone single batch (fresh staging)."""
    counts = np.zeros(num_keys, np.int32)
    slots, _ = host_slots(np.asarray(rows), values, weights, counts)
    return slots


def _segment_reduce_gather(bucket, sw, swv):
    """Per-row segment sums of `sw`/`swv` grouped by `bucket` (K, J) into
    C buckets. bucket is non-decreasing along J, so each bucket's sum is a
    difference of prefix sums at its boundary; the sorted search gives
    lo = #{j : bucket[k, j] <= c} directly."""
    k_rows = bucket.shape[0]
    cumw = torch.cumsum(sw, dim=-1)
    cumwv = torch.cumsum(swv, dim=-1)
    targets = torch.arange(C, dtype=bucket.dtype, device=bucket.device)
    lo = torch.searchsorted(bucket, targets.expand(k_rows, C).contiguous(),
                            right=True)
    gather_at = (lo - 1).clamp(min=0)
    gw = torch.where(lo > 0, torch.gather(cumw, 1, gather_at), 0.0)
    gwv = torch.where(lo > 0, torch.gather(cumwv, 1, gather_at), 0.0)
    zero_col = torch.zeros((k_rows, 1), dtype=torch.float32,
                           device=bucket.device)
    new_w = gw - torch.cat([zero_col, gw[:, :-1]], dim=-1)
    new_wv = gwv - torch.cat([zero_col, gwv[:, :-1]], dim=-1)
    return new_w, new_wv


def _recompress_sorted(sm, sw, cum):
    """Recompress per-row mean-SORTED centroids into C k-buckets with the
    contiguous-segment prefix reduce."""
    tot = cum[:, -1:]
    q_mid = (cum - sw * 0.5) / tot.clamp(min=1e-30)
    bucket = torch.floor(_k_scale(q_mid)).long().clamp(0, C - 1)
    new_w, new_wv = _segment_reduce_gather(bucket, sw, sw * sm)
    new_w = new_w.clamp(min=0.0)  # guard cumsum-difference round-off
    new_m = torch.where(new_w > 0, new_wv / new_w.clamp(min=1e-30), 0.0)
    return new_m, new_w


def _sort_by_mean(means, weights):
    """Per-row stable sort by mean with weightless slots keyed to +inf
    (jax.lax.sort((key, w, m), num_keys=1) in the JAX package)."""
    sort_key = torch.where(weights > 0, means, _INF)
    _, order = torch.sort(sort_key, dim=-1, stable=True)
    return torch.gather(means, -1, order), torch.gather(weights, -1, order)


def _recompress(cat_means, cat_weights):
    """Sort a (K, J) centroid set per row by mean and recompress to C
    k-buckets."""
    sm, sw = _sort_by_mean(cat_means, cat_weights)
    return _recompress_sorted(sm, sw, torch.cumsum(sw, dim=-1))


def apply_batch(state, rows, values, weights, slots=None):
    """Ingest a COO batch of histogram samples into the staging grid, in
    place.

    rows: (B,) int — row index per sample; rows outside [0, K) (PAD_ROW
      padding) are dropped by every scatter.
    values: (B,) f32 sample values; weights: (B,) f32 (1/sample_rate).
    slots: (B,) int staging slot per sample (host_slots); None computes
      ranks for a single batch into fresh staging.
    """
    num_keys = state["wv"].shape[0]
    if slots is None:
        slots = torch.from_numpy(batch_slots(
            rows.cpu().numpy(), values.cpu().numpy(),
            weights.cpu().numpy(), num_keys)).to(rows.device)
    if num_keys == 0 or rows.shape[0] == 0:
        return state
    rows = rows.long()
    valid = (rows >= 0) & (rows < num_keys)
    # dropped samples go to row 0 with neutral contributions (+0 weight
    # and weighted value, ±inf extrema), which leave that row unchanged
    # whatever value the padding carries
    idx = torch.where(valid, rows, 0)
    w_eff = torch.where(valid, weights, 0.0)
    wv = torch.where(valid, weights * values, 0.0)
    vmin = torch.where(valid, values, _INF)
    vmax = torch.where(valid, values, -_INF)
    state["lweight"].index_add_(0, idx, w_eff)
    state["lsum"].index_add_(0, idx, wv)
    # zero values contribute +/-Inf, matching Go's 1/0 (samplers.go:341)
    recip = torch.where(valid, weights / values, 0.0)
    state["lrecip"].index_add_(0, idx, recip)
    state["drecip"].index_add_(0, idx, recip)
    for key, src, how in (("lmin", vmin, "amin"), ("lmax", vmax, "amax"),
                          ("dmin", vmin, "amin"), ("dmax", vmax, "amax")):
        state[key].scatter_reduce_(0, idx, src, how, include_self=True)
    # rank-park each sample into its own staging slot; the min() clamp is
    # the JAX package's correctness backstop should a caller skip compact
    flat = idx * C + slots.long().clamp(max=C - 1)
    state["sweights"].view(-1).index_add_(0, flat, w_eff)
    state["swv"].view(-1).index_add_(0, flat, wv)
    return state


def _fold_grids(state):
    """[main | staging] mean/weight concatenation (K, 2C)."""
    main_w = state["weights"]
    main_m = torch.where(main_w > 0,
                         state["wv"] / main_w.clamp(min=1e-30), 0.0)
    stage_w = state["sweights"]
    stage_m = torch.where(stage_w > 0,
                          state["swv"] / stage_w.clamp(min=1e-30), 0.0)
    return (torch.cat([main_m, stage_m], dim=-1),
            torch.cat([main_w, stage_w], dim=-1))


def compact(state):
    """Fold the staging grid into the main grid with the mean-sorted
    recompress, leaving staging empty (in place)."""
    cat_m, cat_w = _fold_grids(state)
    new_m, new_w = _recompress(cat_m, cat_w)
    state["weights"].copy_(new_w)
    state["wv"].copy_(new_m * new_w)
    state["sweights"].zero_()
    state["swv"].zero_()
    return state


def merge_centroid_rows(state, rows, in_means, in_weights, in_min, in_max,
                        in_recip):
    """Merge externally serialized digests into the table in place (the
    import path, parity with reference worker.go:444-457 /
    merging_digest.go:374-389).

    rows: (B,) int target row per incoming digest (rows outside [0, K)
      are dropped); in_means/in_weights: (B, C) centroid grids;
      in_min/in_max/in_recip: (B,).

    The incoming grids overlay on a per-key grid (same-row digests
    pre-blend by slot), then one sort and recompress over [main | staging
    | incoming] merges them with the store. Rows with neither incoming
    nor staged weight keep their grids verbatim; every other row leaves
    with empty staging."""
    num_keys = state["wv"].shape[0]
    if num_keys == 0 or rows.shape[0] == 0:
        return state
    rows = rows.long()
    valid = (rows >= 0) & (rows < num_keys)
    idx = torch.where(valid, rows, 0)
    state["dmin"].scatter_reduce_(0, idx, torch.where(valid, in_min, _INF),
                                  "amin", include_self=True)
    state["dmax"].scatter_reduce_(0, idx, torch.where(valid, in_max, -_INF),
                                  "amax", include_self=True)
    state["drecip"].index_add_(0, idx, torch.where(valid, in_recip, 0.0))
    w = torch.where(valid[:, None], in_weights, 0.0)
    grid_w = torch.zeros((num_keys, C), dtype=torch.float32,
                         device=w.device).index_add_(0, idx, w)
    grid_wv = torch.zeros_like(grid_w).index_add_(0, idx, w * in_means)
    grid_m = torch.where(grid_w > 0, grid_wv / grid_w.clamp(min=1e-30), 0.0)
    cat_m, cat_w = _fold_grids(state)
    new_m, new_w = _recompress(torch.cat([cat_m, grid_m], dim=-1),
                               torch.cat([cat_w, grid_w], dim=-1))
    touched = ((grid_w.sum(dim=-1) > 0)
               | (state["sweights"].sum(dim=-1) > 0))[:, None]
    state["wv"].copy_(torch.where(touched, new_m * new_w, state["wv"]))
    state["weights"].copy_(torch.where(touched, new_w, state["weights"]))
    state["sweights"].masked_fill_(touched, 0.0)
    state["swv"].masked_fill_(touched, 0.0)
    return state


def _sorted_centroids(state, fold_staging: bool):
    """The flush preamble: (optionally) fold staging, then the per-row
    mean sort with weightless slots keyed to +inf."""
    if fold_staging:
        means, weights = _fold_grids(state)
    else:
        weights = state["weights"]
        means = torch.where(weights > 0,
                            state["wv"] / weights.clamp(min=1e-30), 0.0)
    return _sort_by_mean(means, weights)


def flush_quantiles_packed(state, percentiles: Sequence[float],
                           fold_staging: bool = True) -> torch.Tensor:
    """Per-key digest outputs as one (K, P+10) float32 tensor: quantiles,
    then FLUSH_SCALARS (count, sum, min, max, hmean and the five local
    stats). The sort runs here; the interpolation after it is kernel K1
    on the card and its plain version on the CPU. Unpack on the host with
    unpack_flush."""
    sm, sw = _sorted_centroids(state, fold_staging)
    return tdigest_flush.flush_packed(
        sm, sw, tdigest_flush.scalars_of(state), percentiles)


def flush_export_packed(state, percentiles: Sequence[float]):
    """The forwarding flush: fold staging, sort ONCE, run the quantile
    phase from the sorted pre-merge centroids (kernel K1 on the card),
    and recompress the same sorted arrays into the <= C export grid.

    Returns (flush_packed (K, P+10), export_packed (K, 2C+3):
    [means | weights | dmin dmax drecip]); unpack on the host with
    unpack_flush / unpack_export."""
    sm, sw = _sorted_centroids(state, fold_staging=True)  # (K, 2C)
    packed = tdigest_flush.flush_packed(
        sm, sw, tdigest_flush.scalars_of(state), percentiles)
    new_m, new_w = _recompress_sorted(sm, sw, torch.cumsum(sw, dim=-1))
    export = torch.cat([new_m, new_w, state["dmin"][:, None],
                        state["dmax"][:, None], state["drecip"][:, None]],
                       dim=-1)
    return packed, export


def unpack_export(export: np.ndarray):
    """Host-side inverse of flush_export_packed's export half: views
    (means (K, C), weights (K, C), dmin, dmax, drecip) of one host array
    (float32, so each row is the (C,) float32 row the native digest
    encoder takes)."""
    return (export[:, :C], export[:, C:2 * C], export[:, 2 * C],
            export[:, 2 * C + 1], export[:, 2 * C + 2])


def pack_centroids_many(means_list, weights_list, cap: int = C):
    """Host-side: re-bucket each of a chunk's incoming centroid lists (a
    serialized digest may carry up to ceil(pi*compression/2) ~ 158
    centroids) into <= cap k-scale slots, by the arcsine rule of each
    centroid's mid-rank, with one lexsort and one scatter-add for the
    whole chunk. Returns (K, cap) float32 means/weights.

    The within-digest cumsum is the chunk's cumsum less an exclusive
    prefix base, so it can round differently from a per-digest cumsum and
    move mass one adjacent slot, which the digest grid re-buckets on
    merge anyway (the JAX package's pack_centroids_many, bit for bit)."""
    K = len(means_list)
    out_m = np.zeros((K, cap), np.float32)
    out_w = np.zeros((K, cap), np.float32)
    if K == 0:
        return out_m, out_w
    lens = np.fromiter((len(x) for x in means_list), np.int64, K)
    if int(lens.sum()) == 0:
        return out_m, out_w
    m = np.concatenate([np.asarray(x, np.float64) for x in means_list])
    w = np.concatenate([np.asarray(x, np.float64) for x in weights_list])
    seg = np.repeat(np.arange(K), lens)
    order = np.lexsort((m, seg))  # mean order within each digest
    m, w = m[order], w[order]
    tot = np.bincount(seg, weights=w, minlength=K)
    starts = np.zeros(K, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    cw = np.cumsum(w)
    base = np.where(starts > 0, cw[starts - 1], 0.0)
    seg_cw = cw - np.repeat(base, lens)
    live = np.repeat(tot > 0, lens)
    q_mid = np.zeros_like(seg_cw)
    denom = np.repeat(np.where(tot > 0, tot, 1.0), lens)
    q_mid[live] = ((seg_cw - w * 0.5) / denom)[live]
    k = COMPRESSION * (np.arcsin(np.clip(2 * q_mid - 1, -1, 1)) / math.pi
                       + 0.5)
    bucket = np.clip(np.floor(k).astype(np.int64), 0, cap - 1)
    flat = seg * cap + bucket
    acc_w = np.zeros(K * cap, np.float64)
    acc_wv = np.zeros(K * cap, np.float64)
    wl = np.where(live, w, 0.0)  # weightless digests drop out
    np.add.at(acc_w, flat, wl)
    np.add.at(acc_wv, flat, wl * m)
    acc_w = acc_w.reshape(K, cap)
    acc_wv = acc_wv.reshape(K, cap)
    nz = acc_w > 0
    out_w[nz] = acc_w[nz]
    out_m[nz] = acc_wv[nz] / acc_w[nz]
    return out_m, out_w


def unpack_flush(packed: np.ndarray, num_percentiles: int):
    """Host-side inverse of flush_quantiles_packed: views of one host
    array, in the dict shape the JAX package's flush_quantiles gives."""
    out = {"quantiles": packed[:, :num_percentiles]}
    for i, k in enumerate(FLUSH_SCALARS):
        out[k] = packed[:, num_percentiles + i]
    return out
