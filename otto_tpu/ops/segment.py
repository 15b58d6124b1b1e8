"""Sort-based segment (groupby) primitives.

Every DataFrame groupby / window-rank / join in the reference pipeline
(reference: model/count_co_events.py:60-77 groupby-count,
model/retrieve.py:44-47 ordinal rank over aid, model/count_popularity.py:61-76
rank over cluster, ...) becomes one of the primitives here:

  groupby-sum        -> multi-key stable sort + boundary detection + segment_sum
  rank(.., 'ordinal')-> stable sort + (position - segment_start)
  top-k per group    -> rank + scatter into a dense [groups, k] table
  join on key        -> dense table gather (keys are small ints: aid/session)

All shapes are static; invalid lanes carry the SENTINEL key and sort to the
end, so every groupby is a fixed-shape device program built from sorts,
shifts and scans. The design avoids scatters and flat gathers on the hot
paths; whether that trade still pays on a GPU is open (ROADMAP D7).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

SENTINEL = jnp.int32(2**31 - 1)
NEG_SENTINEL = jnp.int32(-(2**31 - 1))


def _shift_right(x: jnp.ndarray, fill) -> jnp.ndarray:
    """x[i-1] with x[0] := fill, along the last axis.

    Implemented as roll + masked first lane rather than
    concatenate([fill, x[..., :-1]]): the concatenation after lax.sort
    compiled into a far slower program on the accelerator this was first
    tuned for (ROADMAP D7).
    """
    sh = jnp.roll(x, 1, axis=-1)
    lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    return jnp.where(lane == 0, fill, sh)


def _shift_left(x: jnp.ndarray, fill) -> jnp.ndarray:
    """x[i+1] with x[-1] := fill, along the last axis (roll-based)."""
    sh = jnp.roll(x, -1, axis=-1)
    lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    return jnp.where(lane == x.shape[-1] - 1, fill, sh)


# ---------------------------------------------------------------------------
# Flat (1-D) groupby-sum over composite int32 keys
# ---------------------------------------------------------------------------
def sort_compress(
    k1: jnp.ndarray,
    k2: jnp.ndarray,
    v: jnp.ndarray,
    valid: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Groupby (k1, k2) -> sum(v). The device-side equivalent of
    `df.groupby(['aid', 'aid_next']).agg(pl.sum('count'))`
    (reference: model/count_co_events.py:168). SCATTERLESS: boundary
    compaction by a second sort, per-segment sums by segmented scan
    (within-segment accumulation only — no cross-segment overflow).

    Returns (uk1, uk2, uv, n_unique): unique keys packed at the front in
    ascending (k1, k2) order, padding rows carry SENTINEL keys and uv == 0.
    """
    if valid is not None:
        k1 = jnp.where(valid, k1, SENTINEL)
        k2 = jnp.where(valid, k2, SENTINEL)
        v = jnp.where(valid, v, jnp.zeros_like(v))
    k1s, k2s, vs = lax.sort((k1, k2, v), num_keys=2)
    first = (k1s != _shift_right(k1s, NEG_SENTINEL)) | (
        k2s != _shift_right(k2s, NEG_SENTINEL)
    )

    # segmented prefix-sum: last element of each segment = segment total
    (a,) = segmented_scan((vs,), ("sum",), first, axis=0)

    # compact segment ends to the front with a second payload-carrying
    # sort instead of a flat 1-D gather (the scatter/gather-free design,
    # ROADMAP D7)
    is_end = _shift_left(first, True) & (k1s != SENTINEL)
    ck1 = jnp.where(is_end, k1s, SENTINEL)
    ck2 = jnp.where(is_end, k2s, SENTINEL)
    uk1, uk2, uv = lax.sort((ck1, ck2, a), num_keys=2)
    uv = jnp.where(uk1 == SENTINEL, jnp.zeros_like(uv), uv)
    n_unique = jnp.sum(is_end).astype(jnp.int32)
    return uk1, uk2, uv, n_unique


def sort_compress_ends(
    k1: jnp.ndarray,
    k2: jnp.ndarray,
    v: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """sort_compress WITHOUT the front-compaction second sort: unique keys
    stay scattered at their segment-END positions (other lanes carry
    SENTINEL / 0). Half the cost of sort_compress; correct whenever the
    consumer re-sorts anyway (e.g. intermediate merge-ladder runs, whose
    next merge starts with a fresh sort of the concat)."""
    k1s, k2s, vs = lax.sort((k1, k2, v), num_keys=2)
    first = (k1s != _shift_right(k1s, NEG_SENTINEL)) | (
        k2s != _shift_right(k2s, NEG_SENTINEL)
    )
    (a,) = segmented_scan((vs,), ("sum",), first, axis=0)
    is_end = _shift_left(first, True) & (k1s != SENTINEL)
    uk1 = jnp.where(is_end, k1s, SENTINEL)
    uk2 = jnp.where(is_end, k2s, SENTINEL)
    uv = jnp.where(is_end, a, jnp.zeros_like(a))
    n_unique = jnp.sum(is_end).astype(jnp.int32)
    return uk1, uk2, uv, n_unique


def sort_compress_multi(
    k1: jnp.ndarray,
    k2: jnp.ndarray,
    values: Tuple[jnp.ndarray, ...],
    valid: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, Tuple[jnp.ndarray, ...], jnp.ndarray]:
    """Groupby (k1, k2) -> sum of each value column (the multi-aggregate
    groupby, e.g. reference: model/count_popularity.py:61-70)."""
    if valid is not None:
        k1 = jnp.where(valid, k1, SENTINEL)
        k2 = jnp.where(valid, k2, SENTINEL)
        values = tuple(jnp.where(valid, v, jnp.zeros_like(v)) for v in values)
    out = lax.sort((k1, k2) + tuple(values), num_keys=2)
    k1s, k2s, vs = out[0], out[1], list(out[2:])
    first = (k1s != _shift_right(k1s, NEG_SENTINEL)) | (
        k2s != _shift_right(k2s, NEG_SENTINEL)
    )

    # segmented prefix-sums for all value columns in one fused scan
    vs = list(segmented_scan(tuple(vs), ("sum",) * len(vs), first, axis=0))

    # end-marker compaction via a second payload sort (no flat gathers —
    # see sort_compress)
    is_end = _shift_left(first, True) & (k1s != SENTINEL)
    ck1 = jnp.where(is_end, k1s, SENTINEL)
    ck2 = jnp.where(is_end, k2s, SENTINEL)
    outc = lax.sort((ck1, ck2) + tuple(vs), num_keys=2)
    uk1, uk2 = outc[0], outc[1]
    is_pad = uk1 == SENTINEL
    uvs = [jnp.where(is_pad, jnp.zeros_like(a), a) for a in outc[2:]]
    n_unique = jnp.sum(is_end).astype(jnp.int32)
    return uk1, uk2, tuple(uvs), n_unique


def sort_by_keys(keys: Tuple[jnp.ndarray, ...], values: Tuple[jnp.ndarray, ...]):
    """Stable lexicographic sort of `values` by `keys` (ascending)."""
    out = lax.sort(tuple(keys) + tuple(values), num_keys=len(keys), is_stable=True)
    return out[: len(keys)], out[len(keys):]


def segment_starts(seg_sorted: jnp.ndarray) -> jnp.ndarray:
    """For each element of a sorted segment-id array, the index where its
    segment starts."""
    n = seg_sorted.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    first = seg_sorted != _shift_right(seg_sorted, NEG_SENTINEL)
    return lax.cummax(jnp.where(first, pos, 0))


def ordinal_rank_desc(
    group: jnp.ndarray,
    value: jnp.ndarray,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """1-based ordinal rank of `value` (descending) within each `group`,
    ties broken by original order — the polars
    `pl.col(x).rank('ordinal', reverse=True).over(group)` semantics
    (reference: model/retrieve.py:44, model/count_popularity.py:73).

    Invalid lanes get rank SENTINEL.
    """
    n = group.shape[0]
    if valid is not None:
        group = jnp.where(valid, group, SENTINEL)
    neg_v = -value.astype(jnp.int32)
    perm = jnp.arange(n, dtype=jnp.int32)
    g_s, v_s, perm_s = lax.sort((group, neg_v, perm), num_keys=2, is_stable=True)
    starts = segment_starts(g_s)
    rank_sorted = jnp.arange(n, dtype=jnp.int32) - starts + 1
    # inverse permutation via sort (scatterless)
    _, rank = lax.sort((perm_s, rank_sorted), num_keys=1)
    if valid is not None:
        rank = jnp.where(valid, rank, SENTINEL)
    return rank


def ordinal_rank_asc(
    group: jnp.ndarray,
    value: jnp.ndarray,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """1-based ascending ordinal rank within group (reference:
    model/w2vec_aids.py:170 rank of distance)."""
    v = value.astype(jnp.int32)
    return ordinal_rank_desc(group, -v, valid)


# ---------------------------------------------------------------------------
# Dense top-N tables (the device replacement for "join on (aid, aid_next)")
# ---------------------------------------------------------------------------
def build_topn_tables(
    key: jnp.ndarray,
    neighbor: jnp.ndarray,
    values: Tuple[jnp.ndarray, ...],
    n_keys: int,
    n_top: int,
    order_by: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, ...]]:
    """Scatter a sparse (key, neighbor, *values) relation into dense
    [n_keys, n_top] tables ordered by `order_by` desc (default: values[0]).

    This materialises the reference's "keep rank <= first_n neighbours per
    aid" (reference: model/retrieve.py:44-47) as a gatherable dense table:
    lookup of all top-N neighbours of an aid is then a single row gather.

    Returns (neighbor_table [n_keys, n_top] int32 (-1 pad), value_tables).
    """
    order = order_by if order_by is not None else values[0]
    valid = key != SENTINEL
    rank = ordinal_rank_desc(key, order, valid)  # 1-based
    slot = rank - 1
    # scatter with mode='drop': slot >= n_top or invalid (SENTINEL key) dropped
    key_c = jnp.where(valid, key, n_keys)  # out of bounds -> dropped
    nb_table = jnp.full((n_keys, n_top), -1, jnp.int32).at[key_c, slot].set(
        neighbor, mode="drop"
    )
    val_tables = tuple(
        jnp.zeros((n_keys, n_top), v.dtype).at[key_c, slot].set(v, mode="drop")
        for v in values
    )
    return nb_table, val_tables


# ---------------------------------------------------------------------------
# Row-wise (per-session) ops over padded [S, C] tensors
# ---------------------------------------------------------------------------
def rowwise_sort(keys: Tuple[jnp.ndarray, ...], values: Tuple[jnp.ndarray, ...] = ()):
    """Stable sort along the last axis by lexicographic keys."""
    out = lax.sort(
        tuple(keys) + tuple(values), dimension=-1, num_keys=len(keys), is_stable=True
    )
    return out[: len(keys)], out[len(keys):]


def rowwise_unique_sum(
    key: jnp.ndarray, values: Tuple[jnp.ndarray, ...]
) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, ...], jnp.ndarray]:
    """Per row: groupby key -> sum(values). Keys must carry SENTINEL for
    invalid lanes. Returns (unique_keys [S,C] SENTINEL-padded at the back,
    summed values, n_unique [S]).

    The per-session dedup + aggregation at the heart of retrieval
    (reference: model/retrieve.py:391-393 groupby (session, aid_next)).
    """
    cols = {f"v{i}": (v, "sum") for i, v in enumerate(values)}
    uk, out, n_unique = rowwise_groupby(key, cols)
    return uk, tuple(out[f"v{i}"] for i in range(len(values))), n_unique


def rowwise_segment_reduce(
    key: jnp.ndarray,
    values: Tuple[jnp.ndarray, ...],
    reducers: Tuple[str, ...],
) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, ...], jnp.ndarray]:
    """Per-row groupby with mixed reducers ('sum' | 'max' | 'min' | 'count').

    'min'/'max' ignore lanes whose value equals the respective identity
    (SENTINEL for min, NEG_SENTINEL/0 handled by caller).
    """
    assert len(values) == len(reducers)
    cols = {
        f"v{i}": (v, "sum" if r == "count" else r)
        for i, (v, r) in enumerate(zip(values, reducers))
    }
    uk, out, n_unique = rowwise_groupby(key, cols)
    return uk, tuple(out[f"v{i}"] for i in range(len(values))), n_unique


def _roll_right_by(x: jnp.ndarray, d: int, fill, axis: int) -> jnp.ndarray:
    """Shift by d along `axis`, filling the first d lanes (roll-based, as
    _shift_right)."""
    sh = jnp.roll(x, d, axis=axis)
    lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, axis % x.ndim)
    return jnp.where(lane < d, fill, sh)


def segmented_scan(
    values: Tuple[jnp.ndarray, ...],
    reducers: Tuple[str, ...],
    first: jnp.ndarray,
    axis: int = -1,
) -> Tuple[jnp.ndarray, ...]:
    """Inclusive segmented prefix-reduce along `axis` for several columns:
    a Hillis-Steele log-depth network of roll + select steps (shift masks
    shared across columns per step). `first` marks segment starts; after the
    scan, the LAST element of each segment holds the segment's full
    reduction. Sums only accumulate within segments, so i32 never sees
    cross-segment totals."""
    n = values[0].shape[axis]
    vals = list(values)
    # blocked[i]: element i's running window already reaches its segment
    # start — stop absorbing earlier elements. Standard (v, f) monoid:
    # (v1,f1)+(v2,f2) = (f2 ? v2 : op(v1,v2), f1|f2).
    blocked = jnp.broadcast_to(first, values[0].shape)
    d = 1
    while d < n:
        b_sh = _roll_right_by(blocked, d, True, axis)
        for i, (a, red) in enumerate(zip(vals, reducers)):
            ident = _reduce_identity(a.dtype, red)
            a_sh = _roll_right_by(a, d, ident, axis)
            if red == "sum":
                combined = a + a_sh
            elif red == "max":
                combined = jnp.maximum(a, a_sh)
            else:
                combined = jnp.minimum(a, a_sh)
            vals[i] = jnp.where(blocked, a, combined)
        blocked = blocked | b_sh
        d *= 2
    return tuple(vals)


def _reduce_identity(dtype, red: str):
    if red == "sum":
        return jnp.zeros((), dtype)
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.array(
            jnp.finfo(dtype).max if red == "min" else jnp.finfo(dtype).min,
            dtype,
        )
    return jnp.array(SENTINEL if red == "min" else NEG_SENTINEL, dtype)


def rowwise_transport_sort(key: jnp.ndarray, arrays):
    """Stable-sort `arrays` by `key` along the last axis: ONE (key, pos)
    sort, then every column moves through the permutation in dtype-stacked
    take_along_axis gathers. Carrying the columns as sort payload operands
    instead makes compile time superlinear in the sort's operand count.

    Returns (sorted_key, [sorted_arrays...]).
    """
    S, C = key.shape
    pos = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[None, :], (S, C))
    ks, perm = lax.sort((key, pos), dimension=-1, num_keys=1, is_stable=True)
    if not arrays:
        return ks, []
    # stack by dtype: one gather per dtype group
    groups: dict = {}
    for i, a in enumerate(arrays):
        groups.setdefault(jnp.dtype(a.dtype).name, []).append(i)
    outs = [None] * len(arrays)
    for _, idxs in groups.items():
        st = jnp.stack([arrays[i] for i in idxs], axis=0)
        g = jnp.take_along_axis(st, perm[None, :, :], axis=2)
        for j, i in enumerate(idxs):
            outs[i] = g[j]
    return ks, outs


def rowwise_groupby_scan(
    key: jnp.ndarray,
    columns: dict,
) -> Tuple[jnp.ndarray, dict, jnp.ndarray, jnp.ndarray]:
    """Sorted-layout per-row groupby: sort by key (payload transport), then
    segmented-scan each column so the LAST lane of every segment holds the
    segment's full reduction.

    `columns` maps name -> (array [S, C], reducer), reducer in
    {'sum', 'min', 'max', 'carry'}; 'carry' marks columns whose value is
    identical across a segment (per-group attributes) — they ride the sort
    but skip the scan.

    Returns (ks [S, C] sorted keys, {name: scanned [S, C]}, is_end [S, C]
    bool segment-end marks (False on SENTINEL-key lanes), n_unique [S]).
    Downstream consumers must read values at is_end lanes only.
    """
    S, C = key.shape
    names = list(columns)
    ks, sorted_cols = rowwise_transport_sort(
        key, [columns[n][0] for n in names]
    )
    by_name = dict(zip(names, sorted_cols))
    first = ks != _shift_right(ks, NEG_SENTINEL)
    valid_key = ks != SENTINEL

    # group scan work by (dtype, reducer): one stacked scan per group shares
    # the shift masks across columns; within-segment accumulation only, so
    # i32 never sees cross-segment totals
    groups: dict = {}
    for n in names:
        arr, red = columns[n]
        if red == "carry":
            continue
        groups.setdefault((jnp.dtype(arr.dtype).name, red), []).append(n)
    out = dict(by_name)
    for (_, red), gnames in groups.items():
        st = jnp.stack([by_name[n] for n in gnames], axis=0)
        (sc,) = segmented_scan((st,), (red,), first[None, :, :], axis=2)
        for j, n in enumerate(gnames):
            out[n] = sc[j]

    is_end = _shift_left(first, True) & valid_key
    n_unique = jnp.sum(first & valid_key, axis=-1).astype(jnp.int32)
    return ks, out, is_end, n_unique


def rowwise_groupby(
    key: jnp.ndarray,
    columns: dict,
) -> Tuple[jnp.ndarray, dict, jnp.ndarray]:
    """Per-row groupby, SCATTERLESS and GATHERLESS: payload-transport sort +
    segmented scan (rowwise_groupby_scan), then a second payload-transport
    sort keyed on "segment end? key : SENTINEL" compacts each segment's
    total to the front in ascending-key order.

    `columns` maps name -> (array [S, C], reducer), reducer in
    {'sum', 'min', 'max'}.

    Returns (unique_key [S, C] SENTINEL back-padded, {name: reduced [S, C]},
    n_unique [S]). Reduced padding lanes carry each reducer's identity.
    """
    names = list(columns)
    ks, scanned, is_end, n_unique = rowwise_groupby_scan(key, columns)
    comp_key = jnp.where(is_end, ks, SENTINEL)
    uk, comp = rowwise_transport_sort(comp_key, [scanned[n] for n in names])
    is_pad_slot = uk == SENTINEL
    out = {}
    for i, n in enumerate(names):
        ident = _reduce_identity(columns[n][0].dtype, columns[n][1])
        out[n] = jnp.where(is_pad_slot, ident, comp[i])
    return uk, out, n_unique


def rowwise_rank_desc(value: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """1-based ordinal rank (desc) along last axis; invalid lanes -> SENTINEL.
    The vectorized `rank('ordinal', reverse=True).over('session')`
    (reference: model/retrieve.py:150-151,173-182)."""
    S, C = value.shape
    neg_v = jnp.where(valid, -value.astype(jnp.int32), SENTINEL)
    pos = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[None, :], (S, C))
    _, (perm_s,) = rowwise_sort((neg_v,), (pos,))
    rank_sorted = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[None, :], (S, C)) + 1
    # inverse permutation via sort (scatterless)
    _, (rank,) = rowwise_sort((perm_s,), (rank_sorted,))
    return jnp.where(valid, rank, SENTINEL)


def rowwise_rank_asc(value: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    return rowwise_rank_desc(jnp.where(valid, -value, value), valid)
